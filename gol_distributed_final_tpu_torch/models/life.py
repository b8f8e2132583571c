"""The life-like automaton model family.

Any totalistic life-like automaton expressed as a B.../S... rulestring,
compiled to 9-bit masks (bit ``n`` set => the transition applies at
neighbour count ``n``). The masks are what every step in ``ops/`` takes;
``CONWAY`` is the rule the goldens exercise.
"""

from __future__ import annotations

import dataclasses
import functools
import re


def _mask(counts) -> int:
    m = 0
    for c in counts:
        if not 0 <= c <= 8:
            raise ValueError(f"neighbour count out of range: {c}")
        m |= 1 << c
    return m


@dataclasses.dataclass(frozen=True)
class LifeRule:
    """A totalistic life-like rule, e.g. Conway = B3/S23."""

    name: str
    birth_mask: int
    survive_mask: int

    @classmethod
    def from_rulestring(cls, rulestring: str, name: str | None = None) -> "LifeRule":
        m = re.fullmatch(r"B(\d*)/S(\d*)", rulestring.strip(), re.IGNORECASE)
        if m is None:
            raise ValueError(f"not a B/S rulestring: {rulestring!r}")
        birth = [int(ch) for ch in m.group(1)]
        survive = [int(ch) for ch in m.group(2)]
        return cls(
            name=name or rulestring.upper(),
            birth_mask=_mask(birth),
            survive_mask=_mask(survive),
        )

    @property
    def rulestring(self) -> str:
        birth = "".join(str(i) for i in range(9) if self.birth_mask >> i & 1)
        survive = "".join(str(i) for i in range(9) if self.survive_mask >> i & 1)
        return f"B{birth}/S{survive}"

    # ops.stencil is imported in the methods: importing the models loads
    # no torch op module

    def step(self, board):
        """One turn of the byte stencil under this rule, on the board's
        device."""
        from ..ops import stencil

        return stencil.step(
            board, birth_mask=self.birth_mask, survive_mask=self.survive_mask
        )

    def step_n(self, board, n: int):
        """``n`` turns of the byte stencil under this rule."""
        from ..ops import stencil

        return stencil.step_n(
            board, n, birth_mask=self.birth_mask, survive_mask=self.survive_mask
        )

    def step_fn(self):
        """A plain ``board -> board`` function with the masks baked in:
        ``stencil.step`` under this rule."""
        from ..ops import stencil

        return functools.partial(
            stencil.step, birth_mask=self.birth_mask, survive_mask=self.survive_mask
        )


CONWAY = LifeRule.from_rulestring("B3/S23", name="conway")
HIGHLIFE = LifeRule.from_rulestring("B36/S23", name="highlife")
SEEDS = LifeRule.from_rulestring("B2/S", name="seeds")
DAY_AND_NIGHT = LifeRule.from_rulestring("B3678/S34678", name="day-and-night")
