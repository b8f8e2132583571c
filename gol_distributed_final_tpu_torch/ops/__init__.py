from .stencil import ALIVE, DEAD, neighbour_counts, step, step_n, step_n_batch
from .reduce import alive_count, alive_count_batch, alive_cells
from .fused import fused_step_n
from .pallas_stencil import pallas_step_n_fn

__all__ = [
    "ALIVE",
    "DEAD",
    "neighbour_counts",
    "step",
    "step_n",
    "step_n_batch",
    "alive_count",
    "alive_count_batch",
    "alive_cells",
    "fused_step_n",
    "pallas_step_n_fn",
]
