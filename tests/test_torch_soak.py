"""The port's session soaks on the CPU (tests/torch_soak.py): the JAX
package's control-plane soak on the port's ``run``, its oracle the port's
own ``alive_history`` held against the JAX package's, and the on-card
session soak's timeline on a small ``big_session``.

Game of Life is integer-exact: equality, tolerance none.
"""

import numpy as np

from gol_distributed_final_tpu.ops import bitpack as jbit
from gol_distributed_final_tpu_torch.io.pgm import read_pgm
from gol_distributed_final_tpu_torch.ops import tiled, whole_board

from helpers import REPO_ROOT
from torch_soak import control_plane_soak, session_soak

#: the JAX test's budget: 'q' ends the session long before it
N = 200_000


def test_control_plane_soak_random_keys(tmp_path):
    """The JAX package's scenario (seed 7, twelve p/s keys 80 ms apart,
    then 'q', a 30 ms ticker) on the port's ``run`` on the CPU, with its
    assertions (tests/torch_soak.py). The port's history covers the turns
    the session ran and equals the JAX package's ``alive_history`` of the
    same board over those turns of its N."""
    whole_board.reset_counts()
    seen = control_plane_soak(tmp_path / "out", "cpu", turns=N, seed=7)
    assert whole_board.history_plain_calls == 1
    done = seen["done"]
    board = read_pgm(REPO_ROOT / "images" / "64x64.pgm")
    want = np.asarray(jbit.alive_history(jbit.pack(board, 0), N))
    np.testing.assert_array_equal(seen["history"], want[:done])


def test_session_soak_timeline_on_a_small_board(tmp_path):
    """The on-card soak's timeline at a tenth of its minute on a 1024^2
    R-pentomino on the CPU: past the whole-board gate, so on the tiled
    kernel's plain version as 4096^2 is on the card. At least five
    monotone ticks, one pause, the mid-run snapshot, a checkpoint, and
    the final PGM equal to the run resumed from that checkpoint."""
    tiled.reset_counts()
    seen = session_soak(tmp_path, "cpu", size=1024, seconds=6.0, checkpoint_every=200,
                        tick_seconds=0.2)
    assert seen["ticks"] >= 5 and seen["checkpoint_turn"] > 0
    assert tiled.plain_calls > 0
    assert seen["auto_plane"] == "BitPlane"
