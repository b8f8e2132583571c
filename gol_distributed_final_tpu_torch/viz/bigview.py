"""Live window view of an engine-driven big-board session.

The reference's SDL window renders the whole board every turn from
``CellFlipped`` events (sdl/loop.go:30-51), which a 65536^2 board cannot
afford: its raster is 4 GiB and its flips would number billions. Instead
this view periodically takes the engine's atomic ``(state, turn)``
snapshot and decodes ONLY the watched window (bigboard.decode_window: KiB,
not GiB, cross from the card), refreshing the window's pixels. It works
on any plane whose state is a packed tensor or holds one in ``packed``
(ops/sparse.py::SparseState), and with either window backend through the
SetPixel/RenderFrame surface the reference defines (sdl/window.go:10-104).
"""

from __future__ import annotations

import threading

import numpy as np

_WHITE = 0x00FFFFFF


class BigView:
    """Render a fixed window of a (possibly running) engine's packed board.

    ``watch`` spawns a refresh thread; ``stop`` joins it. ``refresh`` is
    also callable directly (no thread) — one frame per call."""

    def __init__(
        self,
        engine,
        y0: int,
        x0: int,
        height: int,
        width: int,
        *,
        word_axis: int = 0,
        window=None,
        interval: float = 0.5,
    ):
        from .window import make_window

        self.engine = engine
        self.y0, self.x0 = y0, x0
        self.window = window or make_window(width, height, "GoL bigview")
        self.word_axis = word_axis
        self.interval = interval
        self.last_turn: int | None = None
        self.live_frames = 0
        self._shown: np.ndarray | None = None  # what the window displays
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def refresh(self) -> bool:
        """Draw one frame from the current engine state. Returns False if
        the engine holds no state yet."""
        from ..bigboard import decode_window

        state, turn = self.engine.state_snapshot()
        if state is None:
            return False
        win = (
            decode_window(
                getattr(state, "packed", state),
                self.y0,
                self.x0,
                self.window.height,
                self.window.width,
                self.word_axis,
            )
            != 0
        )
        # draw through the public SetPixel protocol (the native SDL
        # backend renders via its own texture, so direct buffer writes
        # would bypass it), but only for CHANGED pixels — between
        # refreshes of a settling board that is a small diff
        if self._shown is None:
            self.window.clear_pixels()
            self._shown = np.zeros_like(win)
        for y, x in zip(*np.nonzero(win != self._shown)):
            self.window.set_pixel(int(x), int(y), _WHITE if win[y, x] else 0)
        self._shown = win
        self.window.render_frame()
        self.last_turn = turn
        return True

    def watch(self):
        if self._thread is not None:
            # a second watch() would orphan the first refresh thread and
            # silently drop any pending _error
            raise RuntimeError("BigView is already watching; stop() first")
        self._stop.clear()  # a stop() leaves the event set; re-arm for restart

        def loop():
            try:
                while not self._stop.is_set():
                    if self.refresh():
                        self.live_frames += 1
                    self._stop.wait(self.interval)
            except BaseException as exc:  # surfaced by stop()
                self._error = exc

        self.live_frames = 0
        self._error = None
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Join the watch thread; re-raises any exception it died on (a
        silently dead daemon would otherwise leave a frozen window and a
        green test suite)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            raise self._error
