from .cell import Cell
from .check import check
from .visualise import alive_cells_to_string, visualise_matrix

__all__ = ["Cell", "check", "alive_cells_to_string", "visualise_matrix"]
