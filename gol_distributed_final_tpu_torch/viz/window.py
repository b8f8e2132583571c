"""The visualiser window — the reference SDL window's API
(reference: sdl/window.go:10-104) over two backends:

* ``Window``: headless, buffer-only — always available; what the tests and
  hosts without libSDL2 or a display use. Keeps the ARGB8888 pixel buffer
  and the exact FlipPixel/SetPixel/CountPixels/ClearPixels semantics
  (including the bounds panic, sdl/window.go FlipPixel).
* ``SdlWindow``: delegates to the native SDL2 binding (native/window.cc ->
  libgolwindow.so, built with g++ at first use by ``window_library`` where
  pkg-config or sdl2-config finds libSDL2); ``make_window`` falls back to
  headless where it cannot be built or opened.
"""

from __future__ import annotations

import ctypes
import shlex
import subprocess

import numpy as np

from ..io import native

_WHITE = 0x00FFFFFF


def _sdl2_flags() -> list[str] | None:
    """The compile and link flags of the host's libSDL2, or None."""
    for cmd in (["pkg-config", "--cflags", "--libs", "sdl2"],
                ["sdl2-config", "--cflags", "--libs"]):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=30)
        except (OSError, subprocess.SubprocessError):
            continue
        return shlex.split(out.stdout)
    return None


def window_library():
    """libgolwindow.so built against the host's libSDL2, or None where the
    host has none or the build fails."""
    flags = _sdl2_flags()
    if flags is None:
        return None
    return native.build("golwindow", ["window.cc"], ["-DGOL_HAVE_SDL2", *flags])


class Window:
    """Headless ARGB8888 pixel buffer with the reference window API."""

    def __init__(self, width: int, height: int, title: str = "GoL"):
        self.width = width
        self.height = height
        self.title = title
        self._pixels = np.zeros((height, width), np.uint32)
        self.frames_rendered = 0

    def _check(self, x: int, y: int):
        if not (0 <= x < self.width and 0 <= y < self.height):
            # the reference panics on out-of-bounds flips (sdl/window.go)
            raise IndexError(f"pixel ({x}, {y}) outside {self.width}x{self.height}")

    def flip_pixel(self, x: int, y: int):
        self._check(x, y)
        self._pixels[y, x] ^= _WHITE

    def set_pixel(self, x: int, y: int, argb: int = _WHITE):
        self._check(x, y)
        self._pixels[y, x] = argb

    def count_pixels(self) -> int:
        return int(np.count_nonzero(self._pixels & _WHITE))

    def clear_pixels(self):
        self._pixels[:] = 0

    def render_frame(self):
        self.frames_rendered += 1

    def poll_key(self) -> str | None:
        return None

    def destroy(self):
        pass


class SdlWindow(Window):
    """Native SDL2-backed window over ``lib_path`` (default: the build of
    ``window_library``; the stub build for the ABI tests)."""

    def __init__(
        self, width: int, height: int, title: str = "GoL", lib_path=None
    ):
        super().__init__(width, height, title)
        if lib_path is None:
            lib_path = window_library()
            if lib_path is None:
                raise OSError("no libSDL2 window backend on this host")
        lib = ctypes.CDLL(str(lib_path))
        # declare EVERY signature: on LP64 an undeclared handle argument
        # would be truncated to a 32-bit c_int
        lib.golwin_create.restype = ctypes.c_void_p
        lib.golwin_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
        lib.golwin_flip_pixel.restype = None
        lib.golwin_flip_pixel.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.golwin_set_pixel.restype = None
        lib.golwin_set_pixel.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_uint32,
        ]
        lib.golwin_count_pixels.restype = ctypes.c_long
        lib.golwin_count_pixels.argtypes = [ctypes.c_void_p]
        lib.golwin_clear_pixels.restype = None
        lib.golwin_clear_pixels.argtypes = [ctypes.c_void_p]
        lib.golwin_render_frame.restype = None
        lib.golwin_render_frame.argtypes = [ctypes.c_void_p]
        lib.golwin_poll_key.restype = ctypes.c_int
        lib.golwin_poll_key.argtypes = [ctypes.c_void_p]
        lib.golwin_destroy.restype = None
        lib.golwin_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._handle = ctypes.c_void_p(
            lib.golwin_create(width, height, title.encode())
        )
        if not self._handle:
            raise RuntimeError("SDL window creation failed")

    def flip_pixel(self, x, y):
        super().flip_pixel(x, y)
        self._lib.golwin_flip_pixel(self._handle, x, y)

    def set_pixel(self, x, y, argb=_WHITE):
        super().set_pixel(x, y, argb)
        self._lib.golwin_set_pixel(self._handle, x, y, ctypes.c_uint32(argb))

    def clear_pixels(self):
        super().clear_pixels()
        self._lib.golwin_clear_pixels(self._handle)

    def render_frame(self):
        super().render_frame()
        self._lib.golwin_render_frame(self._handle)

    def poll_key(self) -> str | None:
        code = self._lib.golwin_poll_key(self._handle)
        if code == -1:
            return "q"  # window close quits the controller
        if code <= 0:
            return None
        return chr(code)

    def destroy(self):
        if self._handle:
            self._lib.golwin_destroy(self._handle)
            self._handle = None


def make_window(width: int, height: int, title: str = "GoL") -> Window:
    """SDL where the native backend builds and opens a window on this
    host, else headless."""
    lib_path = window_library()
    if lib_path is not None:
        try:
            return SdlWindow(width, height, title, lib_path=lib_path)
        except (OSError, RuntimeError):
            pass
    return Window(width, height, title)
