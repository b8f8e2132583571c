"""gol_distributed_final_tpu_torch — the Game of Life framework on PyTorch
and CUDA.

The port of ``gol_distributed_final_tpu`` (JAX on a TPU) to an NVIDIA
H100. It keeps the reference system's observable contract (the controller
session, its typed event stream, PGM image IO, the 2-second alive-count
ticker; reference: stubs/stubs.go, gol/event.go, gol/io.go) and the JAX
package's bitboard layout word for word, and computes on the card through
CUDA kernels written by hand (ops/whole_board.py, ops/batch_board.py,
ops/tiled.py for the bitboard, ops/byte_board.py and ops/byte_tiled.py for
the byte board, with their sources in csrc/). It imports nothing of the
JAX package.

The engine takes a step function on the byte board as the JAX engine does:
``run(params, engine_config=EngineConfig(step_n_fn=ops.fused_step_n))``,
or ``ops.pallas_step_n_fn(rule)``.

Package layout:
    ops/       the data planes, the bitboard and byte steps, the kernels'
               wrappers and plain torch versions, their build
    csrc/      the CUDA sources
    models/    life-like automaton rule family (B/S rulestrings)
    engine/    the GoL engine (broker equivalent) + controller (distributor),
               the multi-universe session table
    rpc/       the wire protocol, server, client and the broker process
    io/        PGM P5 codec, images/ -> out/ conventions
    events/    the 6-event observability stream
    utils/     Cell
    device.py  which device an entry point computes on (CUDA by default)
"""

from .params import Params
from .events import (
    AliveCellsCount,
    CellFlipped,
    Event,
    FinalTurnComplete,
    ImageOutputComplete,
    State,
    StateChange,
    TurnComplete,
)
from .utils.cell import Cell

__version__ = "0.1.0"

__all__ = [
    "Params",
    "Cell",
    "Event",
    "AliveCellsCount",
    "ImageOutputComplete",
    "StateChange",
    "CellFlipped",
    "TurnComplete",
    "FinalTurnComplete",
    "State",
    "run",
    "__version__",
]


def run(params, events=None, keypresses=None, **kwargs):
    """Run a full Game of Life session (the ``gol.Run`` equivalent) on the
    CUDA card, or on the CPU with ``device="cpu"``.

    Lazy import so that ``import gol_distributed_final_tpu_torch`` stays
    cheap and does not pull in torch until compute is requested.

    Reference: gol/gol.go:12-41.
    """
    from .engine.controller import run as _run

    return _run(params, events=events, keypresses=keypresses, **kwargs)
