"""A traffic driver for the tests: controller sessions on a seeded pattern
of live cells, each answered with its final board's alive cells.

As ``benchmark/traffic/sessions_closed.py``, back to back from one client
over the broker child, but each input is the configuration's pattern
(``"board": {"kind": "cells", ...}``) placed by ``boards.placements``,
written as a PGM during set-up (a board small enough for one). Each
session keeps the alive cells the reply carries as ``Session.cells`` and
its placement as ``Session.board``, as ``benchmark/checks/cells.py``
reads them; the first session's PGM stays for the check, the others are
deleted.

Parameters: ``turns``, ``pool``.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference
from benchmark.harness import boards, manifest
from benchmark.harness.sessions import Session, now_ns


def _session(ctx, s: Session, images_dir, out_dir, keep_pgm: bool) -> None:
    from gol_distributed_final_tpu_torch.engine.controller import run
    from gol_distributed_final_tpu_torch.params import Params

    h, w = ctx.config["height"], ctx.config["width"]
    s.start_ns = now_ns()
    try:
        result = run(Params(turns=s.turns_asked, image_width=w, image_height=h),
                     broker=ctx.state["remote"], images_dir=str(images_dir),
                     out_dir=str(out_dir))
    except Exception as exc:  # noqa: BLE001 — a failed session is recorded, not fatal
        s.end_ns = now_ns()
        s.error = f"{type(exc).__name__}: {exc}"
        return
    s.end_ns = now_ns()
    s.answered = True
    s.turns = int(result.turns_completed)
    s.alive = len(result.alive)
    s.cells = (np.array([c.y for c in result.alive], np.int64),
               np.array([c.x for c in result.alive], np.int64))
    path = out_dir / f"{w}x{h}x{s.turns_asked}.pgm"
    if keep_pgm:
        s.out_path = path
    else:
        path.unlink()


def setup(ctx) -> None:
    from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker

    p = ctx.traffic
    shape = (ctx.config["height"], ctx.config["width"])
    ys, xs = boards.pattern(manifest.BENCH / ctx.board["file"], shape)
    ctx.state["pool"] = boards.placements(ctx.seed, p["pool"], shape, ys, xs)
    for i, t in enumerate(ctx.state["pool"]):
        d = ctx.workdir / "in" / str(i)
        d.mkdir(parents=True)
        board = np.zeros(shape, np.uint8)
        board[boards.place(ys, xs, t, shape)] = 255
        reference.write_pgm(d / f"{shape[1]}x{shape[0]}.pgm", board)
    ctx.state["remote"] = RemoteBroker(ctx.address)
    warm = Session(-1, ctx.state["pool"][0], p["turns"])
    _session(ctx, warm, ctx.workdir / "in" / "0", ctx.workdir / "warm", keep_pgm=False)
    if not warm.answered:
        raise RuntimeError(f"the warm-up session failed: {warm.error}")


def window(ctx) -> dict:
    p = ctx.traffic
    pool = ctx.state["pool"]
    sessions = []
    t0 = now_ns()
    deadline = t0 + int(ctx.seconds * 1e9)
    while not sessions or sessions[-1].end_ns < deadline:
        i = len(sessions)
        s = Session(i, pool[i % len(pool)], p["turns"])
        _session(ctx, s, ctx.workdir / "in" / str(i % len(pool)), ctx.workdir / "out" / str(i),
                 keep_pgm=i == 0)
        sessions.append(s)
        if s.error is not None:
            break
    return {"window_ns": (t0, sessions[-1].end_ns), "sessions": sessions}


def close(ctx) -> None:
    remote = ctx.state.get("remote")
    if remote is not None:
        remote.close()
