"""Controller sessions back to back from one client (a closed loop).

Each session is the port's ``-server`` path with ``-noVis`` semantics:
``engine.controller.run`` with a ``RemoteBroker``, reading
``<images_dir>/<W>x<H>.pgm`` and writing ``<out_dir>/<W>x<H>x<T>.pgm``.
Inputs are a pool of ``pool`` seeded boards written during set-up and taken
in turn. The window runs from the first session's start to the end of the
session in flight when the seconds have elapsed.

Parameters: ``turns``, ``pool``, and optionally ``warm_turns``: the turns of
the set-up's one warm-up session (at most ``turns``, which it defaults to),
for sessions longer than it takes to warm every kernel, chunk size and the
2 s tick.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference
from benchmark.harness import boards
from benchmark.harness.sessions import Session, now_ns


def _session(ctx, s: Session, images_dir, out_dir) -> None:
    from gol_distributed_final_tpu_torch.engine.controller import run
    from gol_distributed_final_tpu_torch.params import Params

    h, w = ctx.image.shape
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
    s.alive = int(np.count_nonzero(result.world))
    s.out_path = out_dir / f"{w}x{h}x{s.turns_asked}.pgm"


def setup(ctx) -> None:
    from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker

    p = ctx.traffic
    h, w = ctx.image.shape
    ctx.state["pool"] = boards.transforms(ctx.seed, p["pool"], ctx.image.shape)
    for i, t in enumerate(ctx.state["pool"]):
        d = ctx.workdir / "in" / str(i)
        d.mkdir(parents=True)
        reference.write_pgm(d / f"{w}x{h}.pgm", reference.transform(ctx.image, *t))
    ctx.state["remote"] = RemoteBroker(ctx.address)
    # one session of the cell's own size builds and warms the path
    warm = Session(-1, ctx.state["pool"][0], min(p.get("warm_turns", p["turns"]), p["turns"]))
    _session(ctx, warm, ctx.workdir / "in" / "0", ctx.workdir / "warm")
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
        _session(ctx, s, ctx.workdir / "in" / str(i % len(pool)), ctx.workdir / "out" / str(i))
        sessions.append(s)
        if s.error is not None:
            break
    return {"window_ns": (t0, sessions[-1].end_ns), "sessions": sessions}


def close(ctx) -> None:
    remote = ctx.state.get("remote")
    if remote is not None:
        remote.close()
