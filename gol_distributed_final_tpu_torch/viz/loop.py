"""The visualiser event loop — ``sdl.Run`` (reference: sdl/loop.go:9-54).

Consumes the controller's event stream and drives a Window:
``CellFlipped`` XORs a pixel, ``TurnComplete`` renders a frame,
``FinalTurnComplete`` (or stream close) destroys the window. Any event
with a non-empty string form is printed as ``Completed Turns <n> <event>``
(sdl/loop.go:44-47). Window keypresses p/s/q/k are forwarded to the
controller's keypress queue (sdl/loop.go:16-28).
"""

from __future__ import annotations

import queue

from ..events import CellFlipped, FinalTurnComplete, TurnComplete
from .window import make_window


def run(params, events: "queue.Queue", keypresses: "queue.Queue | None" = None, *,
        window=None, on_turn=None):
    """Blocking visualiser loop; returns when the stream ends.

    ``window`` may inject a backend (tests use the headless Window);
    ``on_turn(window, completed_turns)`` is called after each rendered frame.
    """
    from ..engine.controller import CLOSED

    if window is None:
        window = make_window(params.image_width, params.image_height)
    alive = True
    try:
        while True:
            if keypresses is not None and alive:
                key = window.poll_key()
                if key is not None:
                    keypresses.put(key)
            try:
                ev = events.get(timeout=0.02)
            except queue.Empty:
                continue
            if ev is CLOSED:
                return
            if isinstance(ev, CellFlipped) and alive:
                window.flip_pixel(ev.cell.x, ev.cell.y)
            elif isinstance(ev, TurnComplete) and alive:
                window.render_frame()
                if on_turn is not None:
                    on_turn(window, ev.completed_turns)
            elif isinstance(ev, FinalTurnComplete):
                # window goes down now (sdl/loop.go:40); keep draining the
                # stream but never touch the destroyed window again
                window.destroy()
                alive = False
            text = str(ev)
            if text:
                print(f"Completed Turns {ev.get_completed_turns()} {text}")
    finally:
        window.destroy()
