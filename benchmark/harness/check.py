"""The comparison that decides ``correct`` where a configuration names no
check of its own (``benchmark/checks/``).

Every session of the window is held to the plain reference
(``benchmark/reference.py``): its turns completed, its alive count, and
its final board (the PGM the controller wrote) cell for cell. The
reference evolves the configuration's image once for each number of turns
and maps the result by each session's own symmetry and roll, which Conway's
rule on a torus commutes with (the tests show it on every golden file).
Life is exact, so every limit is a count of 0 wrong, and at least one
board has to have been compared.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference

#: the numbers held from below; every other is held from above
AT_LEAST = frozenset({"boards_checked"})


def compare(sessions, ctx) -> dict:
    """``{name: (value, limit, holds)}`` over ``sessions``, against the
    configuration's image (``ctx.image``) and rule."""
    image, rulestring = ctx.image, ctx.config["rule"]
    finals = {}
    unanswered = wrong_turns = wrong_alive = wrong_boards = checked = 0
    for s in sessions:
        if not s.answered:
            unanswered += 1
            continue
        if s.turns_asked not in finals:
            finals[s.turns_asked] = reference.evolve(image, s.turns_asked, rulestring)
        final = finals[s.turns_asked]
        wrong_turns += s.turns != s.turns_asked
        wrong_alive += s.alive != int(np.count_nonzero(final))
        world = reference.read_pgm(s.out_path)
        s.out_path.unlink()
        checked += 1
        expect = reference.transform(final, *s.board)
        wrong_boards += world.shape != expect.shape or bool(
            np.any((world != 0) != (expect != 0)))
    return {
        "unanswered": (unanswered, 0, unanswered <= 0),
        "wrong_turns": (wrong_turns, 0, wrong_turns <= 0),
        "wrong_alive": (wrong_alive, 0, wrong_alive <= 0),
        "wrong_boards": (wrong_boards, 0, wrong_boards <= 0),
        "boards_checked": (checked, 1, checked >= 1),
    }
