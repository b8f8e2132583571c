"""The canonical alive-cell coordinate (reference: util/cell.go:4-6).

``x`` is the column index, ``y`` the row index — the payload type of
``FinalTurnComplete.alive`` and what the golden-image tests assert on.

On the RPC wire a Cell travels under the JAX package's name,
``gol_distributed_final_tpu.utils.cell.Cell``, the one name that
package's unpickler accepts for it (rpc/protocol.py ``WIRE_NAMES``).
"""

from typing import NamedTuple


class Cell(NamedTuple):
    x: int
    y: int
