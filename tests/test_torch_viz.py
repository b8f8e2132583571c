"""The PyTorch port's visualiser and native IO on the CPU, held against the
JAX package's (viz/, io/native.py, native/ there and here): the window's
semantics, the visualiser loop's pixels for the same event stream, the
flip/render protocol through a full session, the big-board view, the
window keys driving a session, the native PGM codec against the Python
one and against the JAX package's bytes, the golwin_* ABI over the port's
own stub build, and the controller's CLI without -noVis. Game of Life is
integer-exact: every comparison is equality.
"""

import ctypes
import os
import queue
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from gol_distributed_final_tpu.io.pgm import write_pgm as jwrite_pgm
from gol_distributed_final_tpu.viz import Window as JWindow
from gol_distributed_final_tpu.viz.loop import run as jviz_run
from gol_distributed_final_tpu_torch import Params, run
from gol_distributed_final_tpu_torch.io import native
from gol_distributed_final_tpu_torch.io.pgm import PgmReader, read_pgm, write_pgm
from gol_distributed_final_tpu_torch.viz import Window
from gol_distributed_final_tpu_torch.viz import window as winmod
from gol_distributed_final_tpu_torch.viz.loop import run as viz_run

from helpers import REPO_ROOT, read_alive_counts

GOLWIN = ("golwin_create", "golwin_flip_pixel", "golwin_set_pixel", "golwin_count_pixels",
          "golwin_clear_pixels", "golwin_render_frame", "golwin_poll_key", "golwin_destroy")


def _board(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((h, w)) < 0.5, 255, 0).astype(np.uint8)


# -- the window and the loop --------------------------------------------------


@pytest.mark.parametrize("cls", [Window, JWindow])
def test_window_flip_set_count_clear(cls):
    w = cls(8, 4)
    w.flip_pixel(0, 0)
    w.flip_pixel(7, 3)
    assert w.count_pixels() == 2
    w.flip_pixel(0, 0)
    assert w.count_pixels() == 1
    w.set_pixel(2, 2)
    assert w.count_pixels() == 2
    w.clear_pixels()
    assert w.count_pixels() == 0


@pytest.mark.parametrize("x,y", [(8, 0), (0, -1), (-1, 3), (0, 4)])
def test_window_bounds_panic(x, y):
    for cls in (Window, JWindow):
        with pytest.raises(IndexError):
            cls(8, 4).flip_pixel(x, y)


def test_loop_pixels_equal_the_reference_for_one_event_stream(tmp_path):
    """One recorded event stream (a 64^2 session with flips) through both
    visualiser loops: the same pixels at every rendered turn, the same
    printed lines."""
    import contextlib
    import io

    from gol_distributed_final_tpu_torch.engine.controller import CLOSED

    p = Params(turns=12, image_width=64, image_height=64)
    events = queue.Queue()
    run(p, events, emit_flips=True, images_dir=REPO_ROOT / "images", out_dir=tmp_path,
        tick_seconds=3600, device="cpu")
    recorded = []
    while True:
        ev = events.get_nowait()
        if ev is CLOSED:
            break
        recorded.append(ev)
    from gol_distributed_final_tpu import events as jevents
    from gol_distributed_final_tpu.engine.controller import CLOSED as JCLOSED
    from gol_distributed_final_tpu.utils import Cell as JCell

    def as_reference(ev):
        """The JAX package's event of the same kind and fields."""
        fields = {f: getattr(ev, f) for f in ev.__dataclass_fields__}
        if "cell" in fields:
            fields["cell"] = JCell(*fields["cell"])
        if "alive" in fields:
            fields["alive"] = [JCell(*c) for c in fields["alive"]]
        if "new_state" in fields:
            fields["new_state"] = jevents.State(int(fields["new_state"]))
        return getattr(jevents, type(ev).__name__)(**fields)

    streams = {"port": recorded + [CLOSED],
               "ref": [as_reference(ev) for ev in recorded] + [JCLOSED]}
    frames, printed = {}, {}
    for name, loop, cls in (("port", viz_run, Window), ("ref", jviz_run, JWindow)):
        q = queue.Queue()
        for ev in streams[name]:
            q.put(ev)
        window = cls(64, 64)
        seen = []
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            loop(p, q, window=window,
                 on_turn=lambda w, turn, seen=seen: seen.append((turn, w._pixels.copy())))
        frames[name], printed[name] = seen, out.getvalue()
    assert [t for t, _ in frames["port"]] == list(range(1, 13))
    assert [t for t, _ in frames["port"]] == [t for t, _ in frames["ref"]]
    for (turn, a), (_, b) in zip(frames["port"], frames["ref"]):
        assert np.array_equal(a, b), turn
    assert printed["port"] == printed["ref"]


def test_viz_loop_reconstructs_board(tmp_path):
    """TestSdl's contract through the port's stack: a session with flips on,
    consumed by the visualiser loop; the window's pixel count at every
    TurnComplete is the golden alive CSV's (sdl_test.go:56-74)."""
    counts = read_alive_counts(REPO_ROOT / "check" / "alive" / "64x64.csv")
    p = Params(turns=20, image_width=64, image_height=64)
    events = queue.Queue()
    seen = []
    window = Window(64, 64)
    viz_thread = threading.Thread(
        target=viz_run, args=(p, events),
        kwargs={"window": window,
                "on_turn": lambda w, turn: seen.append((turn, w.count_pixels()))},
    )
    viz_thread.start()
    run(p, events, emit_flips=True, images_dir=REPO_ROOT / "images",
        out_dir=tmp_path / "out", tick_seconds=3600, device="cpu")
    viz_thread.join(timeout=60)
    assert not viz_thread.is_alive()
    assert [t for t, _ in seen] == list(range(1, 21))
    for turn, count in seen:
        assert count == counts[turn], f"turn {turn}: {count} != {counts[turn]}"
    assert window.frames_rendered == 20


def test_make_window_falls_back_headless(monkeypatch):
    monkeypatch.setattr(winmod, "window_library", lambda: None)
    w = winmod.make_window(4, 4)
    assert type(w) is Window


def test_bigview_tracks_engine_session():
    """A BigView watching an engine-driven big board renders the window of
    the JAX package's run through the SetPixel protocol, live while the
    session runs and exact after it ends; on the sparse plane too."""
    from gol_distributed_final_tpu import bigboard as jbig
    from gol_distributed_final_tpu.ops.plane import BitPlane as JBitPlane
    from gol_distributed_final_tpu_torch import bigboard
    from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
    from gol_distributed_final_tpu_torch.ops.plane import BitPlane
    from gol_distributed_final_tpu_torch.ops.sparse import SparseBitPlane
    from gol_distributed_final_tpu_torch.viz.bigview import BigView

    size, turns, win = 512, 60, 128
    w0 = size // 2 - win // 2
    ref = jbig.decode_window(JBitPlane().step_n(
        jbig.seed_packed(size, jbig.r_pentomino(size)), turns), w0, w0, win, win)

    def hold(engine, state, turn):
        # the 60 turns can end before the watch thread's first refresh on a
        # loaded host; so the run waits at its first chunk until the view
        # has drawn a frame of the live session
        deadline = time.monotonic() + 120
        while view.live_frames < 1 and time.monotonic() < deadline:
            time.sleep(0.005)

    for plane in (BitPlane(device="cpu"), SparseBitPlane(device="cpu")):
        eng = Engine(EngineConfig(final_world=False, min_chunk=2, max_chunk=8, device="cpu",
                                  chunk_hook=hold))
        view = BigView(eng, w0, w0, win, win, window=Window(win, win), interval=0.02).watch()
        state = bigboard.seed_packed(size, bigboard.r_pentomino(size), device="cpu")
        if isinstance(plane, SparseBitPlane):
            state = plane.from_packed(state)
        try:
            eng.run(Params(turns=turns, image_width=size, image_height=size), None,
                    plane=plane, initial_state=state)
        finally:
            view.stop()  # re-raises if the watch thread died
        assert view.live_frames >= 1, "no frame rendered while the run was live"
        assert view.refresh()
        np.testing.assert_array_equal(view.window._pixels != 0, np.asarray(ref) != 0)
        assert view.last_turn == turns


def test_bigview_double_watch_raises():
    from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
    from gol_distributed_final_tpu_torch.viz.bigview import BigView

    view = BigView(Engine(EngineConfig(device="cpu")), 0, 0, 8, 8, window=Window(8, 8),
                   interval=0.05)
    view.watch()
    try:
        with pytest.raises(RuntimeError, match="already watching"):
            view.watch()
    finally:
        view.stop()
    view.watch()
    time.sleep(0.2)
    assert view._thread.is_alive(), "restarted watch thread exited immediately"
    view.stop()
    assert view._thread is None


def test_window_keypresses_drive_full_session(tmp_path):
    """sdl/loop.go:16-28: keys pressed in the window go through the
    visualiser loop into the controller: 's' writes a snapshot PGM, 'p'
    pauses, a second 'p' resumes one turn lower (gol/distributor.go:118),
    'q' quits."""
    from gol_distributed_final_tpu_torch import FinalTurnComplete, State, StateChange

    class ScriptedWindow(Window):
        """A headless window that presses its keys one per poll interval,
        as a user typing in the SDL window."""

        def __init__(self, width, height, keys, interval=0.35):
            super().__init__(width, height)
            self.keys = list(keys)
            self.interval = interval
            self.next_at = time.monotonic() + interval
            self.destroyed = False

        def poll_key(self):
            if self.keys and time.monotonic() >= self.next_at:
                self.next_at = time.monotonic() + self.interval
                return self.keys.pop(0)
            return None

        def destroy(self):
            self.destroyed = True

    p = Params(turns=100_000_000, image_width=64, image_height=64)
    events, keypresses = queue.Queue(), queue.Queue()
    window = ScriptedWindow(64, 64, ["s", "p", "p", "q"])
    collected = []
    orig_get = events.get

    def tee_get(*a, **kw):
        ev = orig_get(*a, **kw)
        collected.append(ev)
        return ev

    events.get = tee_get
    viz_thread = threading.Thread(target=viz_run, args=(p, events, keypresses),
                                  kwargs={"window": window})
    viz_thread.start()
    result = run(p, events, keypresses, images_dir=REPO_ROOT / "images",
                 out_dir=tmp_path / "out", tick_seconds=0.1, device="cpu")
    viz_thread.join(timeout=60)
    assert not viz_thread.is_alive() and window.destroyed
    assert 0 < result.turns_completed < p.turns
    assert (tmp_path / "out" / f"{p.output_filename}.pgm").exists()
    changes = [e for e in collected if isinstance(e, StateChange)]
    paused = [e for e in changes if e.new_state == State.PAUSED]
    executing = [e for e in changes if e.new_state == State.EXECUTING]
    assert len(paused) == 1 and len(executing) == 1
    assert executing[0].completed_turns >= paused[0].completed_turns - 1
    assert len([e for e in changes if e.new_state == State.QUITTING]) == 2
    assert any(isinstance(e, FinalTurnComplete) for e in collected)


def test_visualise_helpers_equal_the_reference():
    from gol_distributed_final_tpu.utils import alive_cells_to_string as jcells
    from gol_distributed_final_tpu.utils import visualise_matrix as jmatrix
    from gol_distributed_final_tpu_torch.utils import (
        Cell, alive_cells_to_string, check, visualise_matrix,
    )

    board = _board(6, 9, seed=4)
    assert visualise_matrix(board, 9, 6) == jmatrix(board, 9, 6)
    given, expected = [Cell(1, 2), Cell(3, 4)], [Cell(1, 2), Cell(8, 5)]
    assert alive_cells_to_string(given, expected, 9, 6) == jcells(given, expected, 9, 6)
    check(None)
    with pytest.raises(ValueError):
        check(ValueError("x"))


# -- the native codec ---------------------------------------------------------


@pytest.fixture(scope="module")
def codec():
    if shutil.which(native.CXX) is None or not native.available():
        pytest.skip("no g++: the native codec cannot be built")
    return native


def test_native_header_and_rows_match_python(codec, tmp_path):
    b = _board(64, 48, seed=1)
    p = tmp_path / "b.pgm"
    write_pgm(p, b)
    w, h, maxval, offset = codec.read_header(p)
    assert (w, h, maxval) == (48, 64, 255)
    np.testing.assert_array_equal(codec.read_rows(p, offset, w, 10, 30), b[10:30])


@pytest.mark.parametrize("shape", [(32, 32), (1, 300), (7, 5)])
def test_native_write_equals_both_python_codecs(codec, tmp_path, shape):
    b = _board(*shape, seed=2)
    paths = [tmp_path / f"{n}.pgm" for n in ("native", "port", "ref")]
    assert codec.write_board(paths[0], b)
    write_pgm(paths[1], b)
    jwrite_pgm(paths[2], b)
    assert paths[0].read_bytes() == paths[1].read_bytes() == paths[2].read_bytes()


def test_large_board_roundtrip_uses_native(codec, tmp_path):
    b = _board(1024, 1024, seed=3)
    p, ref = tmp_path / "big.pgm", tmp_path / "ref.pgm"
    used = codec.used
    write_pgm(p, b)
    np.testing.assert_array_equal(read_pgm(p), b)
    with PgmReader(p) as r:
        np.testing.assert_array_equal(r.read_rows(100, 900), b[100:900])
    # the write: reads are numpy's at every size (the native read measured
    # slower on the card's host)
    assert codec.used == used + 1
    jwrite_pgm(ref, b)
    assert p.read_bytes() == ref.read_bytes()


def test_native_header_rejects_garbage(codec, tmp_path):
    p = tmp_path / "g.pgm"
    p.write_bytes(b"not a pgm at all")
    assert codec.read_header(p) is None


def test_python_codec_serves_without_native(tmp_path):
    """GOL_TPU_NO_NATIVE: the large-board path falls back to the Python
    codec and writes the same bytes, in a process of its own."""
    script = (
        "import numpy as np, sys\n"
        "from gol_distributed_final_tpu_torch.io import native\n"
        "from gol_distributed_final_tpu_torch.io.pgm import read_pgm, write_pgm\n"
        "b = np.where(np.random.default_rng(3).random((1024, 1024)) < 0.5, 255, 0)"
        ".astype(np.uint8)\n"
        "write_pgm(sys.argv[1], b)\n"
        "assert (read_pgm(sys.argv[1]) == b).all()\n"
        "assert not native.available() and native.used == 0\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), GOL_TPU_NO_NATIVE="1")
    out = tmp_path / "py.pgm"
    subprocess.run([sys.executable, "-c", script, str(out)], check=True, env=env,
                   timeout=120)
    ref = tmp_path / "ref.pgm"
    jwrite_pgm(ref, _board(1024, 1024, seed=3))
    assert out.read_bytes() == ref.read_bytes()


# -- the golwin_* ABI over the port's stub build ------------------------------


@pytest.fixture(scope="module")
def stub_lib():
    """window.cc built against the vendored no-op SDL (native/sdl2_stub/):
    the golwin_* exports of the real build, on a host without libSDL2."""
    if shutil.which(native.CXX) is None:
        pytest.skip("no g++: the window stub cannot be built")
    path = native.build("golwindow_stub", ["window.cc", "sdl2_stub/sdl_stub.cc"],
                        ["-DGOL_HAVE_SDL2", "-Isdl2_stub"])
    assert path is not None, "the window stub failed to build"
    return path


def test_all_declared_symbols_exist(stub_lib):
    lib = ctypes.CDLL(str(stub_lib))
    for sym in GOLWIN:
        getattr(lib, sym)


def test_golwin_exports_equal_the_reference_build(stub_lib, tmp_path):
    """The port's window.cc exports the golwin_* ABI of the JAX package's:
    the same symbols from both builds against the vendored stub."""
    if shutil.which("nm") is None:
        pytest.skip("no nm")
    ref_dir = REPO_ROOT / "gol_distributed_final_tpu" / "native"
    ref = tmp_path / "libref.so"
    subprocess.run([native.CXX, *native.CXXFLAGS, "-DGOL_HAVE_SDL2", "-Isdl2_stub", "-o",
                    str(ref), "window.cc", "sdl2_stub/sdl_stub.cc"],
                   cwd=ref_dir, check=True, capture_output=True, timeout=120)

    def exports(path):
        out = subprocess.run(["nm", "-D", "--defined-only", str(path)], check=True,
                             capture_output=True, text=True).stdout
        return sorted(line.split()[-1] for line in out.splitlines()
                      if line.split()[-1].startswith("golwin_"))

    assert exports(stub_lib) == exports(ref) == sorted(GOLWIN)


def test_sdlwindow_drives_native_abi(stub_lib):
    """The real SdlWindow over the stub-backed library: after every
    mutation the native buffer's count equals the Python shadow's."""
    win = winmod.SdlWindow(16, 8, "abi-test", lib_path=stub_lib)
    try:
        native_count = lambda: int(win._lib.golwin_count_pixels(win._handle))  # noqa: E731
        assert native_count() == 0
        win.flip_pixel(0, 0)
        win.flip_pixel(15, 7)
        win.flip_pixel(3, 4)
        assert win.count_pixels() == 3 == native_count()
        win.flip_pixel(3, 4)
        assert win.count_pixels() == 2 == native_count()
        win.set_pixel(5, 5)
        win.set_pixel(6, 5, 0x00ABCDEF)
        assert win.count_pixels() == 4 == native_count()
        win.render_frame()
        win.render_frame()
        assert int(win._lib.sdl_stub_render_count()) >= 2
        win.clear_pixels()
        assert win.count_pixels() == 0 == native_count()
        with pytest.raises(IndexError):
            win.flip_pixel(16, 0)
    finally:
        win.destroy()
    assert win._handle is None


def test_poll_key_through_native_switch(stub_lib):
    win = winmod.SdlWindow(4, 4, "keys", lib_path=stub_lib)
    try:
        assert win.poll_key() is None
        for ch in "pqsk":
            win._lib.sdl_stub_push_key(ord(ch))
        win._lib.sdl_stub_push_key(ord("x"))  # not in the keymap
        assert [win.poll_key() for _ in range(4)] == ["p", "q", "s", "k"]
        assert win.poll_key() is None
        win._lib.sdl_stub_push_quit()
        assert win.poll_key() == "q"  # window close quits the controller
    finally:
        win.destroy()


def _stub_hooks(lib):
    lib.sdl_stub_trace.restype = ctypes.c_char_p
    lib.sdl_stub_violations.restype = ctypes.c_char_p
    return lib


def test_sdl_usage_contract_full_session(stub_lib):
    lib = _stub_hooks(ctypes.CDLL(str(stub_lib)))
    lib.sdl_stub_reset()
    win = winmod.SdlWindow(16, 8, "contract", lib_path=stub_lib)
    win.flip_pixel(2, 3)
    win.render_frame()
    win.render_frame()
    win.destroy()
    assert lib.sdl_stub_violations() == b"", lib.sdl_stub_violations()
    frame = "Update,Clear,Copy,Present"
    want = f"Init,CreateWindow,CreateRenderer,CreateTexture,{frame},{frame}," \
           "DestroyTexture,DestroyRenderer,DestroyWindow,Quit"
    assert lib.sdl_stub_trace().decode() == want
    lib.sdl_stub_reset()


def test_make_window_uses_native_when_present(stub_lib, monkeypatch):
    monkeypatch.setattr(winmod, "window_library", lambda: stub_lib)
    w = winmod.make_window(8, 8)
    try:
        assert isinstance(w, winmod.SdlWindow)
    finally:
        w.destroy()


# -- the controller's CLI without -noVis -------------------------------------


def test_cli_without_novis_writes_the_golden_pgm(tmp_path):
    (tmp_path / "images").symlink_to(REPO_ROOT / "images")
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    r = subprocess.run([sys.executable, "-m", "gol_distributed_final_tpu_torch", "-w", "64",
                        "-h", "64", "-turns", "100", "-device", "cpu"],
                       capture_output=True, text=True, timeout=240, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    golden = REPO_ROOT / "check" / "images" / "64x64x100.pgm"
    assert (tmp_path / "out" / "64x64x100.pgm").read_bytes() == golden.read_bytes()
    assert "Completed Turns 100 Quitting" in r.stdout
