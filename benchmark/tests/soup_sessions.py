"""A traffic driver for the tests: controller sessions on seeded soups,
keeping windows of each final board.

As ``benchmark/traffic/sessions_closed.py``, back to back from one client
over the broker child, but each input is a soup (``harness/soup.py``) of
its own seed, drawn from the run's, written as a PGM during set-up. After
each session the driver keeps ``windows`` blocks of ``window`` x ``window``
cells of the final board (the first straddles both edges of the torus, the
others lie where the seed puts them) and deletes the PGM; the first
session's PGM stays for the check's alive count. ``Session.board`` is the
session's soup seed, as ``benchmark/checks/window.py`` reads it.

Parameters: ``turns``, ``pool``, ``windows``, ``window``.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference
from benchmark.harness import soup
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
    s.alive = int(np.count_nonzero(result.world))
    path = out_dir / f"{w}x{h}x{s.turns_asked}.pgm"
    final = reference.read_pgm(path)
    size = ctx.traffic["window"]
    s.windows = [(y0, x0, final.take(range(y0, y0 + size), 0, mode="wrap")
                  .take(range(x0, x0 + size), 1, mode="wrap"))
                 for y0, x0 in ctx.state["corners"]]
    if keep_pgm:
        s.out_path = path
    else:
        path.unlink()


def setup(ctx) -> None:
    from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker

    p = ctx.traffic
    h, w = ctx.config["height"], ctx.config["width"]
    rng = np.random.default_rng(ctx.seed % 2**64)
    ctx.state["pool"] = [int(x) for x in rng.integers(2**32, size=p["pool"])]
    half = p["window"] // 2
    ctx.state["corners"] = [(-half, -half)] + [
        (int(rng.integers(h)), int(rng.integers(w))) for _ in range(p["windows"] - 1)]
    for i, seed in enumerate(ctx.state["pool"]):
        d = ctx.workdir / "in" / str(i)
        d.mkdir(parents=True)
        reference.write_pgm(d / f"{w}x{h}.pgm",
                            soup.region(seed, 0, 0, h, w, h, w, ctx.board["density"]))
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
