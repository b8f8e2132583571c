from .window import Window, make_window
from .loop import run

__all__ = ["Window", "make_window", "run"]
