#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gol_distributed_final_tpu_torch)
on one NVIDIA card. Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from the checkout's sources, holds each kernel
against its plain torch version, drives the port's main paths with every
launch counted (controller sessions through ``run()``, a 16384^2 board
through ``Engine.run``, a broker on loopback serving the controller's
``-server`` sessions and 256 concurrent ``SessionRun``s, and the sessions
bench shape, 1000 x 128^2 x 100 turns, through ``SessionTable``), checks
the results against the repository's golden fixtures and sequential
references, drives the engine's step-function override (the nine golden
sessions through ``pallas_step_n_fn`` and through ``fused_step_n``, which
run the byte kernels, and two seeded boards through both, held against the
bitboard plane: the largest square under the whole-board byte kernel's
gate, on a cluster, and 4096^2 past it, on the byte tiles), drives
checkpoints and resume (512^2 sessions with a checkpoint every 1000 turns
read back against check/alive and resumed through ``Engine.run`` and the
CLI's ``-resume``; a turn-50 checkpoint resumed in process and over brokers
started with ``-resume`` and ``-ckpt-keep 2``; a packed checkpoint of the
16384^2 R-pentomino) and the big-board entry point (the 65536^2
R-pentomino, BASELINE config 5, through ``run_big_board`` and the
``bigboard`` CLI, and a 16384^2 ``big_session`` whose streamed PGM is read
back), drives the activity-sparse plane (the 16384^2 R-pentomino on the
auto route, the 65536^2 one adopted with ``SparseBitPlane.from_packed``,
and a 512^2 sparse session with periodic checkpoints resumed to its
golden), runs a controller session without ``-noVis`` through the
visualiser and holds the native PGM codec against the Python one, drives
the workers backend (four worker processes on the card and workers
brokers started through their CLIs serving ``-server`` sessions on the
resident, haloed and 2-D tile wires; a 4096^2 soup x 1000 turns through
``WorkersBackend`` over four in-process workers whose strips stay on the
card, every strip batch on the strip kernel, held against
``DeviceBackend``), and
times the kernels with CUDA events and the profiler's device time,
sparse against dense included, and the workers' fused strip batch against
their numpy loop (the table that sets ``FUSED_STRIP_MIN_CELLS``). The kernels compile the
four named rules in; the parity phases also run a rule outside them
(B36/S125) and check, by the kernels' names in the profiler's trace, that
it ran the run-time-rule instantiation. Any failed check
raises, so the exit code is non-zero and the closing JSON line is never
printed. Without a CUDA device, or without the package beside it, it
exits non-zero before printing any result.

    python3 chip_smoke.py --kernel-times [TREE]

times only the kernels (K1, K2, the tiled kernel, K5, K6 and, where the
tree has it, the sparse kernel and the strip kernel) of the port in
the checkout TREE (default: this one) and prints one JSON line, so that two
trees can be compared in turns within one call on one card.

    python3 chip_smoke.py --workers-times [TREE]

runs phase 20b's workers run alone (a seeded 4096^2 soup x 1000 turns
over four in-process workers) on the port in TREE and prints its wall and
mean StripStep handler time as one JSON line, for the same comparison.

Game of Life is integer-exact: every comparison is equality (tolerance 0).
"""

from __future__ import annotations

import contextlib
import csv
import gc
import io
import inspect
import json
import os
import pathlib
import queue
import re
import socket
import subprocess
import sys
import threading
import time

REPO = pathlib.Path(__file__).resolve().parent
SEED = 20261016
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_OPS_PER_CLOCK_PER_SM = 64  # CUDA C++ Programming Guide, cc 9.0 table


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def trace(fn):
    """torch.profiler's trace of ``fn()`` on the card. On the H100 a trace
    sometimes comes back without some of its window's kernels (its first
    launch above all) while holding the calls that launched them, and such
    records can turn up in a later window instead. So an empty window
    follows each trace and takes what comes late, ``window_kernels`` drops
    what started before its window, and the callers check what a trace holds
    and take another if it falls short."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    with profile(activities=activities):
        torch.cuda.synchronize()
    return prof


def window_kernels(prof, pattern: str) -> list[tuple[str, float]]:
    """``(name, device time in us)`` of every kernel whose name matches
    ``pattern`` in a trace, leaving out any that started before the window's
    first launch call: a record that arrives late from an earlier window
    carries that window's time."""
    from torch.autograd import DeviceType

    events = prof.events()
    calls = [ev.time_range.start for ev in events
             if ev.device_type == DeviceType.CPU and ev.name.startswith("cudaLaunchKernel")]
    if not calls:
        return []
    first = min(calls)
    return [(ev.name, ev.time_range.end - ev.time_range.start) for ev in events
            if ev.device_type == DeviceType.CUDA and ev.time_range.start >= first
            and re.search(pattern, ev.name)]


def traced_kernels(fn, pattern: str, complete) -> list[str]:
    """The short names (no namespace, no arguments) of the kernels matching
    ``pattern`` that ``fn()`` launched, from the profiler's trace. ``fn``
    runs twice in a window, and windows are taken, up to eight, until
    ``complete(names)`` holds for the names seen so far (see ``trace``).
    Raises with those names if it never does."""
    names = set()
    for _ in range(8):
        prof = trace(lambda: (fn(), fn()))
        names |= {re.sub(r"^void |\(.*$", "", name.replace("(anonymous namespace)::", ""))
                  for name, _ in window_kernels(prof, pattern)}
        if complete(sorted(names)):
            return sorted(names)
    raise RuntimeError(f"check failed: the profiler's traces held only {sorted(names)}")


def device_ms(fn, kernel: str, reps: int, per_call: int = 1) -> tuple[float, int]:
    """``(ms, launches)``: the mean device time of one launch of the CUDA
    kernel named ``kernel`` (a regular expression), from torch.profiler's
    trace of ``fn()``, which makes ``per_call`` such launches: the kernel's
    own time. CUDA events around back-to-back calls measure the host's
    launch rate instead once a kernel is shorter than its wrapper's host
    work. A window holds ``reps`` + 1 calls after a warm-up. A trace may
    lack some of its launches (see ``trace``), which does not move their
    mean: it counts if it holds at least half of the launches of ``reps``
    calls and no more than all, else another is taken, up to eight; after
    that the fullest trace stands, or, if none held a launch, CUDA events
    per call, and a line says so. The mean is over the launches the trace
    holds; their number comes back with it."""
    def calls():
        for _ in range(reps + 1):
            fn()

    fn()
    least = -(-reps * per_call // 2)
    fullest = []
    for attempt in range(8):
        times = [us for _, us in window_kernels(trace(calls), rf"::(?:{kernel})[<(]")]
        if least <= len(times) <= (reps + 1) * per_call and sum(times) > 0:
            if attempt:
                print(f"  device_ms: the trace of {kernel} held enough launches at attempt "
                      f"{attempt + 1}")
            return sum(times) / len(times) / 1e3, len(times)
        if len(fullest) < len(times) <= (reps + 1) * per_call:
            fullest = times
    # a timing is no check of the kernel: say what the traces held and go on
    if sum(fullest) > 0:
        print(f"  device_ms: no trace of {kernel} held {least} launches; the mean is over "
              f"the {len(fullest)} of the fullest")
        return sum(fullest) / len(fullest) / 1e3, len(fullest)
    print(f"  device_ms: no trace of {kernel} held a launch; CUDA events per call stand in")
    return cuda_ms(fn, reps=reps) / per_call, 0


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


class Proc:
    """A subprocess of this checkout's Python whose output lines a reader
    thread queues, so that waiting for a line has a timeout."""

    def __init__(self, args, env=None):
        self.proc = subprocess.Popen(
            [sys.executable, *args], cwd=REPO, text=True,
            env=dict(os.environ, PYTHONPATH=str(REPO), **(env or {})),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        self.lines: queue.Queue = queue.Queue()
        self.seen: list = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def wait_for(self, text: str, timeout: float = 120) -> str:
        deadline = time.monotonic() + timeout
        while True:
            line = self.lines.get(timeout=max(0.01, deadline - time.monotonic()))
            if line is None:
                raise RuntimeError(f"check failed: process exited: {''.join(self.seen)}")
            self.seen.append(line)
            if text in line:
                return line

    def port(self, text: str) -> int:
        return int(self.wait_for(text).rsplit(":", 1)[1].split()[0])

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


def kernel_label(mangled: str) -> str:
    """A kernel instantiation's short name from its mangled one, e.g.
    ``tiled<0, 8, StaticRule<8, 0, 16>>``."""
    kernel = re.search(
        r"(whole_board|tiled|byte_board_bits|byte_board_bytes|byte_board|byte_tiled|"
        r"sparse_step|sparse_scatter|sparse_dilate|sparse_list|strip_steps)_kernel",
        mangled)
    name = kernel.group(1) if kernel else mangled[:40]
    args = re.findall(r"Li(\d+)E", mangled)
    rule = re.search(r"StaticRuleILj(\d+)ELj(\d+)ELj(\d+)E", mangled)
    if rule:
        args.append(f"StaticRule<{', '.join(rule.groups())}>")
    elif "DynamicRule" in mangled:
        args.append("DynamicRule")
    return f"{name}<{', '.join(args)}>" if args else name


def ptxas_summary(reports: dict) -> list[str]:
    """One line per instantiation of the bitboard kernels' rules (the tiled
    kernel's K = 1..8 folded into a register range) and per byte kernel:
    registers and spill bytes from nvcc's ``-Xptxas -v`` report."""
    rows = {}
    for source, report in sorted(reports.items()):
        name = None
        for line in report.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if m:
                name = m.group(1)
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if name and (spill or regs):
                key = re.sub(r"^tiled<(\d), \d, ", r"tiled<\1, K, ", kernel_label(name))
                entry = rows.setdefault(key, {"regs": [], "spill": 0, "n": set()})
                entry["n"].add(name)
                if regs:
                    entry["regs"].append(int(regs.group(1)))
                if spill:
                    entry["spill"] = max(entry["spill"], int(spill.group(1)) + int(spill.group(2)))
    return [f"{key}: {len(e['n'])} instantiation(s), {min(e['regs'])}-{max(e['regs'])} "
            f"registers, {e['spill']} spill bytes" for key, e in sorted(rows.items())]


def sass_loop(library, want: tuple[str, ...]) -> str:
    """The innermost loop that stores the most words in the kernel whose
    mangled name holds every string of ``want``, from ``cuobjdump -sass``:
    its instructions per stored word (one STS per output word), or why it
    could not be read."""
    import shutil

    tool = shutil.which("cuobjdump") or (
        "/usr/local/cuda/bin/cuobjdump" if os.path.exists("/usr/local/cuda/bin/cuobjdump")
        else None)
    if tool is None:
        return "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    body = None
    for chunk in sass.split("Function : ")[1:]:
        if all(w in chunk.split("\n", 1)[0] for w in want):
            body = chunk
    if body is None:
        return "kernel not found"
    instrs, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            instrs.append((addr, m.group(2)))
    spans = []
    for addr, text in instrs:
        b = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", text)
        if b:
            target = labels.get(b.group(1)) if b.group(1) else int(b.group(2), 16)
            if target is not None and target <= addr:
                spans.append((target, addr))
    loops = []
    for lo, hi in spans:
        if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi) for l2, h2 in spans):
            continue  # not innermost
        ops = [t for a, t in instrs if lo <= a <= hi]
        stores = sum(1 for t in ops if re.search(r"\bSTS\b", t))
        if stores and any(re.search(r"\bLDS\b", t) for t in ops):  # not a copy loop
            loops.append((-stores, len(ops), ops))
    if not loops:
        return "no loop found"
    stores, n, ops = min(loops)
    count = dict.fromkeys(("LOP3", "SHF", "LDS", "STS", "other"), 0)
    for text in ops:
        parts = text.split()
        op = (parts[1] if parts[0].startswith("@") else parts[0]).split(".")[0]
        count[op if op in count else "other"] += 1
    return (f"{n} instructions for {-stores} words, {n / -stores:.2f} per word ("
            + ", ".join(f"{k} {v}" for k, v in count.items()) + ")")


def workers_run(rpc_worker, broker, dev, soup, turns: int, k: int, around=None, flag=None):
    """``soup`` x ``turns`` through a WorkersBackend over four in-process
    workers of the imported port on ``dev`` (resident wire, depth k,
    GOL_WORKER_FUSED unset), its run inside ``around()`` where given:
    ``(result, wall s, {(worker, turn): counts}, [handler seconds],
    services)``. ``flag.on`` is True inside each StripStep handler."""
    from gol_distributed_final_tpu_torch.rpc.protocol import Methods, Request

    os.environ.pop("GOL_WORKER_FUSED", None)
    wservers = [rpc_worker.serve(0, device=dev) for _ in range(4)]
    batches, service = {}, []
    for wserver, wservice in wservers:
        def stepped(req, _step=wservice.strip_step):
            if flag is not None:
                flag.on = True
            try:
                res = _step(req)
            finally:
                if flag is not None:
                    flag.on = False
            batches[(req.worker, req.initial_turn)] = list(res.counts)
            service.append(res.service_seconds)
            return res

        wserver.register(Methods.STRIP_STEP, stepped)
    backend = broker.WorkersBackend([f"127.0.0.1:{s.port}" for s, _ in wservers],
                                    wire="resident", halo_depth=k)
    req = Request(world=soup, turns=turns, threads=4, image_width=soup.shape[1],
                  image_height=soup.shape[0])
    try:
        gc.collect()
        with around() if around is not None else contextlib.nullcontext():
            t0 = time.monotonic()
            res = backend.run(req)
            wall = time.monotonic() - t0
    finally:
        backend.close()
        for wserver, _ in wservers:
            wserver.stop()
    return res, wall, batches, service, [svc for _, svc in wservers]


def workers_times(tree: str) -> int:
    """Phase 20b's run alone on the port in ``tree`` (a checkout's root),
    after a 512^2 warm-up: a seeded 4096^2 soup x 1000 turns over four
    in-process workers, its wall and mean StripStep handler time as one
    JSON line with a digest of the final board, so that two trees can be
    compared in turns within one call on one card."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from gol_distributed_final_tpu_torch.rpc import broker, integrity
    from gol_distributed_final_tpu_torch.rpc import worker as rpc_worker

    check(pathlib.Path(rpc_worker.__file__).is_relative_to(pathlib.Path(tree).resolve()),
          f"the port imported from {tree}")
    rng = np.random.default_rng(SEED)
    soup = np.where(rng.random((4096, 4096)) < 0.3, 255, 0).astype(np.uint8)
    # a warm-up run first: the kernel's build, the CUDA context and the
    # workers' first buffers stay out of the timed run
    workers_run(rpc_worker, broker, torch.device("cuda"), soup[:512, :512], 16, 8)
    res, wall, _, service, _ = workers_run(rpc_worker, broker, torch.device("cuda"), soup,
                                           1000, 8)
    check(res.turns_completed == 1000 and len(service) == 500, "the workers run")
    print(json.dumps({"tree": tree, "card": nvidia_smi("name,power.limit"), "wall_s": wall,
                      "turns_per_s": 1000 / wall,
                      "handler_ms": 1e3 * sum(service) / len(service),
                      "board": integrity.array_digest(res.world)}))
    return 0


def kernel_times(tree: str) -> int:
    """Time the kernels of the port in ``tree`` (a checkout's root) at the
    smoke's shapes, and print them as one JSON line: the parent-and-change
    comparison, run in turns within one call. Only calls that every tree of
    the port takes are made."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from gol_distributed_final_tpu_torch.ops import (
        batch_board, byte_board, byte_tiled, tiled, whole_board,
    )

    check(pathlib.Path(whole_board.__file__).is_relative_to(pathlib.Path(tree).resolve()),
          f"the port imported from {tree}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def words(shape):
        return torch.from_numpy(
            rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
        ).to(dev)

    def cells(shape):
        return torch.from_numpy(
            np.where(rng.random(shape) < 0.35, 255, 0).astype(np.uint8)
        ).to(dev)

    p512, b1000, b256 = words((16, 512)), words((1000, 4, 128)), words((256, 4, 128))
    t16k, t4k = words((512, 16384)), words((128, 4096))
    # K5 with its form forced where the tree's wrapper takes one (a board
    # past that tree's gate is then timed too), K6 at 8 and 32 turns a launch
    c64, c192, c256 = cells((64, 64)), cells((192, 192)), cells((256, 256))
    c512, c4096 = cells((512, 512)), cells((4096, 4096))
    k5, k6 = "byte_board(?:_bits|_bytes)?_kernel", "byte_tiled_kernel"
    takes_form = "form" in inspect.signature(byte_board.step_n).parameters
    forced = {"form": "bits-cols"} if takes_form else {}
    byte_calls = {
        "k5_256_n100": (lambda: byte_board.step_n(c256, 100, **forced), k5, 20),
        "k5_64_n8": (lambda: byte_board.step_n(c64, 8, **forced), k5, 50),
        "k5_192_n100": (lambda: byte_board.step_n(c192, 100, **forced), k5, 20),
        "k6_512_k8": (lambda: byte_tiled.step_n(c512, 8, turns_per_launch=8), k6, 50),
        "k6_4096_k8": (lambda: byte_tiled.step_n(c4096, 8, turns_per_launch=8), k6, 20),
        "k6_4096_k32": (lambda: byte_tiled.step_n(c4096, 32, turns_per_launch=32), k6, 20),
    }
    if takes_form:
        byte_calls["k5_512_n8"] = (lambda: byte_board.step_n(c512, 8, **forced), k5, 50)
        byte_calls["k5_512_n100"] = (lambda: byte_board.step_n(c512, 100, **forced), k5, 20)
    times = {
        "k1_512_n100": cuda_ms(lambda: whole_board.step_n(p512, 100, counted=True), reps=50),
        "k2_1000x128_n100": cuda_ms(lambda: batch_board.step_n(b1000, 100), reps=20),
        "k2_256x128_n64": cuda_ms(lambda: batch_board.step_n(b256, 64), reps=50),
        "tiled_16384_k8": cuda_ms(lambda: tiled.step_n(t16k, tiled.MAX_TURNS), reps=10),
        "tiled_4096_k8": cuda_ms(lambda: tiled.step_n(t4k, tiled.MAX_TURNS), reps=50),
    }
    device = {
        "k2_256x128_n64": device_ms(lambda: batch_board.step_n(b256, 64),
                                    "whole_board_kernel", reps=20)[0],
        "tiled_4096_k8": device_ms(lambda: tiled.step_n(t4k, tiled.MAX_TURNS),
                                   "tiled_kernel", reps=20)[0],
    }
    for name, (fn, kernel, reps) in byte_calls.items():
        device[name] = device_ms(fn, kernel, reps=reps)[0]
        times[name] = cuda_ms(fn, reps=reps)
    if (pathlib.Path(tree) / "gol_distributed_final_tpu_torch" / "ops" / "sparse_tiles.py").exists():
        # the sparse kernel, in the trees that have it: one 8-turn block
        # (with the dispatch's list pass) on 16384^2 with random words in
        # about 5% of the default tiles
        from gol_distributed_final_tpu_torch.ops import sparse, sparse_tiles

        tile = sparse.sparse_tile_shape((512, 16384))
        chosen = torch.from_numpy(rng.random((512 // tile[0], 16384 // tile[1])) < 0.0057)
        mask = chosen.to(dev).repeat_interleave(tile[0], 0).repeat_interleave(tile[1], 1)
        soup = torch.where(mask, t16k, torch.zeros_like(t16k))
        grid = sparse.occupancy_grid(soup, *tile)
        cap = sparse._pow2_ceil(grid.numel())

        def block():
            return sparse_tiles.dispatch(soup, grid, 1, tile, 8, cap, 8, 12)

        device["sparse_16384_5pct_block"] = device_ms(
            block, "sparse_(?:list|step|scatter|dilate)_kernel", reps=20, per_call=4)[0] * 4
        times["sparse_16384_5pct_block"] = cuda_ms(block, reps=20)
    if (pathlib.Path(tree) / "gol_distributed_final_tpu_torch" / "ops" / "strip_steps.py").exists():
        # the strip kernel, in the trees that have it: one 8-turn batch of a
        # 1024-row, 4096-wide strip with its bands
        from gol_distributed_final_tpu_torch.ops import strip_steps

        block = cells((1024 + 16, 4096))

        def batch():
            return strip_steps.strip_steps(block, 8, 1024, attest=True)

        device["strip_1040x4096_k8"] = device_ms(batch, "strip_steps_kernel", reps=20)[0]
        times["strip_1040x4096_k8"] = cuda_ms(batch, reps=20)
        if hasattr(strip_steps, "strip_batch"):
            # the persistent grid's size and the tile at the same batch: one
            # CTA an SM walking two tiles, one a tile (256), a cap of 66,
            # and the small tile; and the batch without bands and sums
            top, strip, bottom = block[:8], block[8:1032], block[1032:]
            for label, attest, kw in (("ctas132", True, {"ctas": 132}),
                                      ("ctas256", True, {"ctas": 256}),
                                      ("ctas66", True, {"ctas": 66}),
                                      ("small", True, {"tile": strip_steps.SMALL_TILE}),
                                      ("no_attest", False, {})):
                into = strip_steps.batch_outputs(1024, 4096, 8, attest, dev)
                device[f"strip_1040x4096_k8_{label}"] = device_ms(
                    lambda: strip_steps.strip_batch(top, strip, bottom, 8, attest, into=into,
                                                    **kw),
                    "strip_steps_kernel", reps=20)[0]
            # one launch of k = 1..32 turns on a 1024-row strip: the launch's
            # fixed cost (gather, epilogue) against its cost a turn
            for k in (1, 2, 4, 8, 16, 32):
                kblock = cells((1024 + 2 * k, 4096))
                into = strip_steps.batch_outputs(1024, 4096, k, True, dev)
                device[f"strip_1024x4096_k{k}_launch"] = device_ms(
                    lambda: strip_steps.strip_batch(kblock[:k], kblock[k:k + 1024],
                                                    kblock[k + 1024:], k, True, into=into),
                    "strip_steps_kernel", reps=20)[0]
    print(json.dumps({"tree": tree, "card": nvidia_smi("name,power.limit"), "ms": times,
                      "device_ms": device}))
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from gol_distributed_final_tpu_torch import FinalTurnComplete, Params, run
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing: {exc}", file=sys.stderr)
        return 1
    from gol_distributed_final_tpu_torch import bigboard
    from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
    from gol_distributed_final_tpu_torch.engine.checkpoint import (
        generation_path, load_packed_checkpoint, load_verified_checkpoint,
        rotate_generations, save_checkpoint, save_packed_checkpoint,
    )
    from gol_distributed_final_tpu_torch.engine.controller import CLOSED
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm
    from gol_distributed_final_tpu_torch.models import (
        CONWAY, DAY_AND_NIGHT, HIGHLIFE, SEEDS, LifeRule,
    )
    from gol_distributed_final_tpu_torch.__main__ import main as controller_main
    from gol_distributed_final_tpu_torch.engine.sessions import SessionTable
    from gol_distributed_final_tpu_torch.ops import (
        _build, batch_board, bitpack, byte_board, byte_tiled, sparse, sparse_tiles,
        strip_steps, tiled, whole_board,
    )
    from gol_distributed_final_tpu_torch.ops.auto import auto_batch_plane, auto_plane
    from gol_distributed_final_tpu_torch.ops.batched import BatchBitPlane
    from gol_distributed_final_tpu_torch.ops.fused import FusedBitPlane, fused_step_n
    from gol_distributed_final_tpu_torch.ops.pallas_stencil import pallas_step_n_fn
    from gol_distributed_final_tpu_torch.ops.plane import BitPlane
    from gol_distributed_final_tpu_torch.ops.sparse import SparseBitPlane
    from gol_distributed_final_tpu_torch.rpc import broker, integrity
    from gol_distributed_final_tpu_torch.rpc import worker as rpc_worker
    from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker, RpcError
    from gol_distributed_final_tpu_torch.rpc.protocol import Request

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # -- 1. the card ------------------------------------------------------
    card = nvidia_smi("name,power.limit")
    print(card)
    card_tag = f"[{card}]"
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int32_rate = INT32_OPS_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6
    print(f"int32 rate for the bound: {INT32_OPS_PER_CLOCK_PER_SM} ops/clock/SM x "
          f"{sms} SMs x {max_sm_mhz:.0f} MHz = {int32_rate:.4g} ops/s; "
          f"memory {HBM_BYTES_PER_S:.3g} B/s")

    # -- 2. build every kernel from csrc/ ---------------------------------
    t0 = time.monotonic()
    reports = _build.build()
    print(f"phase 2 build: {len(reports)} sources compiled in "
          f"{time.monotonic() - t0:.2f} s into {_build.BUILD_DIR}")
    for line in ptxas_summary(reports):
        print(f"  ptxas: {line}")
    for name in _build.SOURCES:
        check(_build.library_path(name).exists(), f"{name} library built")
    conway = "StaticRuleILj8ELj0ELj16E"
    wide_tile = "TileILi{}ELi{}E".format(*byte_tiled.TILE)
    for name, want in (("whole_board", ("whole_board_kernelILi0E", conway)),
                       ("tiled", ("tiled_kernelILi0ELi8E", conway)),
                       ("byte_board", ("byte_board_bits_kernelILi8E", conway)),
                       ("byte_tiled", ("byte_tiled_kernel", wide_tile, conway)),
                       ("strip_steps", ("strip_steps_kernel", wide_tile, "Lb1E"))):
        print(f"  SASS, the Conway turn loop of {kernel_label(''.join(want))}: "
              f"{sass_loop(_build.library_path(name), want)}")

    # -- 3. each kernel against its plain version -------------------------
    def random_words(shape):
        return torch.from_numpy(
            rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
        ).to(dev)

    def tile_soup(shape, tile, frac, seed):
        """Random words in round(q x tiles) random tiles of ``tile`` words
        (at least one), q drawn so that about ``frac`` of the tiles are
        active once the occupancy grid is dilated (1 - (1 - q)^9 = frac);
        made on the card."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        tr, tc = tile
        grid_shape = (shape[0] // tr, shape[1] // tc)
        tiles = grid_shape[0] * grid_shape[1]
        q = 1 - (1 - frac) ** (1 / 9)
        chosen = torch.zeros(tiles, dtype=torch.bool, device=dev)
        chosen[torch.randperm(tiles, device=dev, generator=gen)[:max(1, round(q * tiles))]] = True
        mask = chosen.view(grid_shape).repeat_interleave(tr, 0).repeat_interleave(tc, 1)
        words = torch.randint(-2**31, 2**31, shape, dtype=torch.int64, device=dev,
                              generator=gen).to(torch.int32)
        return torch.where(mask, words, torch.zeros_like(words))

    rules = (CONWAY, HIGHLIFE, SEEDS, DAY_AND_NIGHT)
    # the bitboard kernels compile those four in; any other rule runs their
    # run-time-rule instantiation
    other = LifeRule.from_rulestring("B36/S125")
    check(not bitpack.is_compiled_rule(other.birth_mask, other.survive_mask),
          "B36/S125 is outside the compiled rules")
    bit_rules = rules + (other,)
    k1_err = 0
    k1_cases = 0
    # the sessions' boards: 64^2 and 512^2
    for size in (64, 512):
        board = np.where(rng.random((size, size)) < 0.35, 255, 0).astype(np.uint8)
        for word_axis in (0, 1):
            packed = bitpack.pack(board, word_axis, dev)
            for rule in bit_rules:
                for n in (1, 7, 100):
                    got, got_counts = whole_board.step_n(
                        packed, n, word_axis, rule.birth_mask, rule.survive_mask,
                        counted=True,
                    )
                    want, want_counts = whole_board.step_n_plain(
                        packed, n, word_axis, rule.birth_mask, rule.survive_mask
                    )
                    torch.cuda.synchronize()
                    err = max(max_abs_err(got, want), max_abs_err(got_counts, want_counts))
                    check(err == 0, f"whole-board {size}^2 {rule.name} n={n} "
                                    f"word_axis={word_axis}: max abs err {err}")
                    k1_err = max(k1_err, err)
                    k1_cases += 1
    print(f"phase 3 parity: whole-board kernel equals its plain version in "
          f"{k1_cases} cases (64^2 and 512^2, 4 rules and B36/S125, n in 1/7/100, both "
          f"packings, counts)")

    tiled_err = 0
    tiled_cases = 0
    # 4096^2 in both packings, 1024x16384, and the real-size board of phase 6
    for shape, word_axis in (((128, 4096), 0), ((4096, 128), 1), ((32, 16384), 0),
                             ((512, 16384), 0), ((45, 300), 0), ((300, 45), 1)):
        packed = random_words(shape)
        for rule in (CONWAY, other):
            masks = (rule.birth_mask, rule.survive_mask)
            whole = bitpack.bit_step_n(packed, 13, word_axis, *masks)
            for k in (1, 3, 8):
                got = tiled.step_n(packed, 13, word_axis, *masks, turns_per_launch=k)
                want = tiled.step_n_plain(packed, 13, word_axis, *masks, turns_per_launch=k)
                torch.cuda.synchronize()
                err = max(max_abs_err(got, want), max_abs_err(got, whole))
                check(err == 0, f"tiled {shape} word_axis={word_axis} {rule.name} k={k}: "
                                f"max abs err {err}")
                tiled_err = max(tiled_err, err)
                tiled_cases += 1
    # the 65536^2 board the big-board entry points give the kernel (phase
    # 16): one 8-turn launch on random words, so every one of its 32768
    # tiles, the last ones' torus wrap among them, holds live words
    packed = random_words((2048, 65536))
    got = tiled.step_n(packed, tiled.MAX_TURNS)
    want = tiled.step_n_plain(packed, tiled.MAX_TURNS)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    del want
    err = max(err, max_abs_err(got, bitpack.bit_step_n(packed, tiled.MAX_TURNS)))
    check(err == 0, f"tiled 65536^2 Conway k=8: max abs err {err}")
    tiled_err = max(tiled_err, err)
    tiled_cases += 1
    del packed, got
    print(f"phase 3 parity: tiled kernel equals its plain version and the "
          f"whole-torus bit_step_n in {tiled_cases} cases (4096^2 both packings, "
          f"1024x16384, 16384^2, and packed 45x300 / 300x45 with ragged tiles; "
          f"Conway and B36/S125, k in 1/3/8, n=13; and one 8-turn launch on random "
          f"words at 65536^2)")

    k2_err = 0
    k2_cases = 0
    # the batched kernel (K2) at the sessions' sizes: B boards of random
    # words, every universe and its row counts against the plain version;
    # the last is the shape the sessions bench below runs and times
    shapes = [(size, batch) for size in (64, 128, 512) for batch in (1, 7, 300)]
    for size, batch in shapes + [(128, 256), (128, 1000)]:
        for word_axis in (0, 1):
            packed = random_words((batch,) + bitpack.packed_shape(size, size, word_axis))
            for rule in bit_rules:
                for n in (1, 7, 100):
                    got, got_counts = batch_board.step_n(
                        packed, n, word_axis, rule.birth_mask, rule.survive_mask
                    )
                    want, want_counts = batch_board.step_n_plain(
                        packed, n, word_axis, rule.birth_mask, rule.survive_mask
                    )
                    torch.cuda.synchronize()
                    err = max(max_abs_err(got, want),
                              max_abs_err(got_counts, want_counts))
                    check(err == 0, f"batched {batch} x {size}^2 {rule.name} n={n} "
                                    f"word_axis={word_axis}: max abs err {err}")
                    k2_err = max(k2_err, err)
                    k2_cases += 1
    print(f"phase 3 parity: batched kernel equals its plain version in {k2_cases} "
          f"cases (B in 1/7/300 at 64^2, 128^2 and 512^2, and B=256 and 1000 at 128^2; "
          f"4 rules and B36/S125, n in 1/7/100, both packings, counts)")

    # which instantiation each rule launched: the kernels' names in the
    # profiler's trace (StaticRule<...> compiled, DynamicRule at run time)
    for rule, kind in ((CONWAY, "StaticRule<8u, 0u, 16u>"), (other, "DynamicRule")):
        masks = (rule.birth_mask, rule.survive_mask)
        p64 = random_words((3, 2, 64))
        # K1 and K2 are one kernel, so two names: it and the tiled kernel
        short = traced_kernels(
            lambda: (whole_board.step_n(p64[0], 3, 0, *masks),
                     batch_board.step_n(p64, 3, 0, *masks),
                     tiled.step_n(p64[0], 3, 0, *masks)),
            r"::(whole_board|tiled)_kernel<",
            lambda names: (len(names) >= 2 and any(n.startswith("whole_board") for n in names)
                           and any(n.startswith("tiled") for n in names)))
        check(len(short) == 2 and all(kind in name for name in short),
              f"{rule.name} launched {short}")
        print(f"phase 3 rule: {rule.name} ({rule.rulestring}) ran {'; '.join(short)}")

    def random_bytes(shape):
        return torch.from_numpy(
            np.where(rng.random(shape) < 0.35, 255, 0).astype(np.uint8)
        ).to(dev)

    def random_values(shape):
        """Cells alive with probability 0.35, as any byte of 1..255."""
        alive = rng.random(shape) < 0.35
        values = rng.integers(1, 256, size=shape).astype(np.uint8)
        return torch.from_numpy(np.where(alive, values, 0).astype(np.uint8)).to(dev)

    smem_limit = whole_board.smem_limit(dev)
    k5_err = 0
    k5_cases = {"bits-cols": 0, "bits-rows": 0, "bytes": 0}
    k5_clusters = set()
    # the step-function sessions' boards (16^2, 64^2, 512^2), the timed 256^2,
    # a rectangle, boards only one packing takes, the largest square under
    # the gate, the largest the crossover table times, and the largest
    # square of the byte form; the form is forced, so boards past the gate
    # run here too
    gate_side = int(byte_board.MAX_CELLS ** 0.5) // 32 * 32
    check(byte_board.fits((gate_side, gate_side), dev)
          and not byte_board.fits((gate_side + 32, gate_side + 32), dev),
          f"{gate_side}^2 is the largest 32-aligned square under the byte kernel's gate")
    check(byte_board.smem_bytes((340, 340)) <= smem_limit < byte_board.smem_bytes((341, 341)),
          "340^2 is the largest square the byte form holds in a block")
    both = ("bits-cols", "bits-rows")
    k5_shapes = {(16, 16): ("bytes",), (24, 33): ("bytes",), (340, 340): ("bytes",),
                 (64, 64): both + ("bytes",), (128, 128): both, (160, 160): both,
                 (256, 256): both,
                 (512, 512): both, (96, 160): both, (64, 48): ("bits-rows",),
                 (96, 100): ("bits-rows",), (40, 64): ("bits-cols",),
                 (gate_side, gate_side): both, (1024, 1024): both}
    for shape, forms in k5_shapes.items():
        check(byte_board.form(shape) == forms[0], f"{shape} routes to {forms[0]}")
        board = random_values(shape)
        for rule in bit_rules:
            for n in (1, 7, 100):
                want = byte_board.step_n_plain(board, n, rule.birth_mask, rule.survive_mask)
                for form in forms:
                    # None: what the launcher picks; then every cluster it can
                    # pick from that divides the lines and fits a block
                    clusters = [None]
                    if form != "bytes":
                        lines = byte_board._lines(shape, form)[1]
                        clusters += [c for c in (1, 2, 4, 8) if lines % c == 0 and
                                     byte_board.smem_bytes(shape, form, c) <= smem_limit]
                    for cluster in clusters:
                        got = byte_board.step_n(board, n, rule.birth_mask, rule.survive_mask,
                                                form=form, cluster=cluster)
                        torch.cuda.synchronize()
                        err = max_abs_err(got, want)
                        check(err == 0, f"byte board {shape} {rule.name} n={n} {form} "
                                        f"cluster={cluster}: max abs err {err}")
                        k5_err = max(k5_err, err)
                        k5_cases[form] += 1
                        k5_clusters.add(cluster or byte_board.cluster_size(shape, form))
    check(k5_clusters == {1, 2, 4, 8}, f"cluster sizes run: {sorted(k5_clusters)}")
    print(f"phase 3 parity: whole-board byte kernel equals its plain version in "
          f"{sum(k5_cases.values())} cases ({k5_cases['bits-cols']} with columns packed, "
          f"{k5_cases['bits-rows']} with rows packed, {k5_cases['bytes']} as bytes; 16^2, "
          f"24x33, 340^2, 64^2, 128^2, 160^2, 256^2, 512^2, 96x160, 64x48, 96x100, 40x64, the "
          f"gate's {gate_side}^2 and the crossover table's 1024^2; clusters of 1, 2, 4 and 8 blocks and the launcher's own pick; "
          f"4 rules and B36/S125, n in 1/7/100; cells alive as any byte of 1..255)")
    # a cluster the card cannot schedule (16 is past the portable 8) is a
    # refused launch: it raises, and the next launch runs
    try:
        byte_board.step_n(random_bytes((512, 512)), 3, cluster=16)
    except RuntimeError as exc:
        print(f"phase 3 refusal: a cluster of 16 blocks raised: {exc}")
    else:
        raise RuntimeError("check failed: a cluster of 16 blocks was not refused")
    small = random_bytes((64, 64))
    check(torch.equal(byte_board.step_n(small, 3), byte_board.step_n_plain(small, 3)),
          "the launch after a refused one")

    k6_err = 0
    k6_cases = 0
    # the JAX package's test shape, the 512^2 sessions' board, a wide board,
    # ragged boards and one smaller than any window; on both tiles where the
    # board is small enough to spare the time
    for shape in ((64, 128), (512, 512), (4096, 4096), (45, 300), (300, 45), (5, 7)):
        board = random_values(shape)
        tiles = (None,) if shape[0] > 512 else (None, byte_tiled.TILE, byte_tiled.SMALL_TILE)
        for rule in bit_rules:
            for k in (1, 8, 32):
                whole = byte_board.step_n_plain(board, k, rule.birth_mask, rule.survive_mask)
                for tile in tiles:
                    args = (board, k, rule.birth_mask, rule.survive_mask)
                    got = byte_tiled.step_n(*args, turns_per_launch=k, tile=tile)
                    want = byte_tiled.step_n_plain(*args, turns_per_launch=k, tile=tile)
                    torch.cuda.synchronize()
                    err = max(max_abs_err(got, want), max_abs_err(got, whole))
                    check(err == 0, f"byte tiles {shape} {rule.name} k={k} tile={tile}: "
                                    f"max abs err {err}")
                    k6_err = max(k6_err, err)
                    k6_cases += 1
    print(f"phase 3 parity: byte-tile kernel equals its plain version and the whole-torus "
          f"stencil in {k6_cases} cases (64x128, 512^2, 4096^2, 45x300, 300x45, 5x7; the "
          f"tile picked by size and, up to 512 rows, both tiles forced; 4 rules and "
          f"B36/S125, one launch of 1/8/32 turns; cells alive as any byte of 1..255)")

    # which instantiation the byte kernels launched: bits in a cluster of 8
    # for 512^2 (forced: it is past the gate), bytes for 24x33, the rule
    # compiled in or at run time
    for rule, kind in ((CONWAY, "StaticRule<8u, 0u, 16u>"), (other, "DynamicRule")):
        masks = (rule.birth_mask, rule.survive_mask)
        b512, b24 = random_bytes((512, 512)), random_bytes((24, 33))

        def complete(names):
            bits = [n for n in names if n.startswith("byte_board_bits_kernel<8, ")]
            tiles = [n for n in names if n.startswith("byte_tiled_kernel<")]
            return (len(bits) == 1 and kind in bits[0] and len(tiles) == 2
                    and all(kind in n for n in tiles) and "byte_board_bytes_kernel" in names
                    and len(names) == 4)

        names = traced_kernels(
            lambda: (byte_board.step_n(b512, 3, *masks, form="bits-cols"),
                     byte_board.step_n(b24, 3, *masks),
                     byte_tiled.step_n(b512, 3, *masks),
                     byte_tiled.step_n(b512, 3, *masks, tile=byte_tiled.TILE)),
            r"::byte_(board|tiled)\w*_kernel", complete)
        print(f"phase 3 rule: {rule.name} ({rule.rulestring}) ran {'; '.join(names)}")

    # the activity-sparse kernel against its plain program (the same torch
    # ops, on the card): dispatches of 3 blocks from soups of random words
    # in random tiles, 5% and 20% of the grid active once dilated, at
    # 4096^2 and 16384^2 (the default tile) for h = 1..8 and with a capacity
    # a quarter of the count (an overflow); each compiled rule and B36/S125;
    # the R-pentomino across tile edges and a glider across the torus
    # corner on every explicit tile of the tests, in long dispatches from a
    # tight capacity; then the plane itself on the card against the plane
    # on the CPU after every step_n call
    def sparse_case(label, packed, tile, h_turns, capacity, rule, n_blocks=3):
        grid = sparse.occupancy_grid(packed, *tile)
        masks = (rule.birth_mask, rule.survive_mask)
        got = sparse_tiles.dispatch(packed, grid, n_blocks, tile, h_turns, capacity, *masks)
        want = sparse_tiles.dispatch_plain(packed, grid, n_blocks, tile, h_turns, capacity,
                                           *masks)
        torch.cuda.synchronize()
        err = max(max_abs_err(got.packed, want.packed), max_abs_err(got.grid, want.grid))
        same = (got.blocks_done, got.overflow, got.active_sum, got.count) == (
            want.blocks_done, want.overflow, want.active_sum, want.count)
        check(err == 0 and same, f"sparse {label}: max abs err {err}, kernel "
                                 f"{got[2:]} plain {want[2:]}")
        return err, got

    sp_err = sp_cases = sp_overflows = 0
    for size in (4096, 16384):
        shape = bitpack.packed_shape(size, size)
        tile = sparse.sparse_tile_shape(shape)
        total = (shape[0] // tile[0]) * (shape[1] // tile[1])
        for frac in (0.05, 0.20):
            packed = tile_soup(shape, tile, frac, seed=size + int(frac * 100))
            count = int(sparse.occupancy_grid(packed, *tile).sum())
            capacity = min(sparse._pow2_ceil(max(count, 8) * 2), sparse._pow2_ceil(total))
            for h_turns in range(1, 9):
                err, _ = sparse_case(f"{size}^2 {count}/{total} active h={h_turns}",
                                     packed, tile, h_turns, capacity, CONWAY)
                sp_err, sp_cases = max(sp_err, err), sp_cases + 1
            err, run_ = sparse_case(f"{size}^2 overflow", packed, tile, 8,
                                    max(1, count // 4), CONWAY)
            check(run_.overflow and run_.blocks_done == 0, f"{size}^2: no overflow")
            sp_err, sp_cases, sp_overflows = max(sp_err, err), sp_cases + 1, sp_overflows + 1

    def with_edge_tiles(packed, tile, seed):
        """``packed`` with random words in the eight tiles on the torus's
        edges: the four corners and the middle of each side, whose halos
        and dilation wrap."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        tr, tc = tile
        gr, gc = packed.shape[0] // tr, packed.shape[1] // tc
        out = packed.clone()
        for ty, tx in ((0, 0), (0, gc - 1), (gr - 1, 0), (gr - 1, gc - 1),
                       (0, gc // 2), (gr - 1, gc // 2), (gr // 2, 0), (gr // 2, gc - 1)):
            out[ty * tr:(ty + 1) * tr, tx * tc:(tx + 1) * tc] = torch.randint(
                -2**31, 2**31, (tr, tc), dtype=torch.int64, device=dev,
                generator=gen).to(torch.int32)
        return out

    # the shapes the main path gives the kernel beyond the soups above:
    # 65536^2 (phase 16b, a 256 x 512 grid of 8 x 128 tiles) and 512^2 with
    # its default tile (phase 18), each a soup plus live tiles on the
    # torus's edges and corners, and 512^2's own board; each bucket is the
    # plane's for its count, and one a quarter of the count overflows
    edge_boards = []
    shape65 = bitpack.packed_shape(65536, 65536)
    tile65 = sparse.sparse_tile_shape(shape65)
    edge_boards.append(("65536^2 soup and torus-edge tiles", tile65, (1, 8), with_edge_tiles(
        tile_soup(shape65, tile65, 0.01, seed=65536), tile65, seed=1)))
    edge_boards.append(("65536^2 torus-edge tiles alone", tile65, (8,), with_edge_tiles(
        torch.zeros(shape65, dtype=torch.int32, device=dev), tile65, seed=2)))
    shape512 = bitpack.packed_shape(512, 512)
    tile512 = sparse.sparse_tile_shape(shape512)
    edge_boards.append(("512^2 soup and torus-edge tiles", tile512, range(1, 9), with_edge_tiles(
        tile_soup(shape512, tile512, 0.2, seed=512), tile512, seed=3)))
    edge_boards.append(("512^2 images/512x512.pgm", tile512, (1, 8),
                        bitpack.pack(read_pgm(REPO / "images" / "512x512.pgm"), 0, dev)))
    for label, tile, hs, packed in edge_boards:
        total = (packed.shape[0] // tile[0]) * (packed.shape[1] // tile[1])
        count = int(sparse.occupancy_grid(packed, *tile).sum())
        capacity = min(sparse._pow2_ceil(max(count, 8) * 2), sparse._pow2_ceil(total))
        for h_turns in hs:
            err, run_ = sparse_case(f"{label}, tile {tile}, {count}/{total} active h={h_turns}",
                                    packed, tile, h_turns, capacity, CONWAY)
            check(run_.blocks_done > 0, f"sparse {label} h={h_turns}: no block ran")
            sp_err, sp_cases = max(sp_err, err), sp_cases + 1
        if count >= 8:
            err, run_ = sparse_case(f"{label} overflow", packed, tile, 8, max(1, count // 4),
                                    CONWAY)
            check(run_.overflow and run_.blocks_done == 0, f"{label}: no overflow")
            sp_err, sp_cases, sp_overflows = max(sp_err, err), sp_cases + 1, sp_overflows + 1
    del edge_boards, packed
    shape4k = bitpack.packed_shape(4096, 4096)
    tile4k = sparse.sparse_tile_shape(shape4k)
    packed = tile_soup(shape4k, tile4k, 0.05, seed=7)
    count = int(sparse.occupancy_grid(packed, *tile4k).sum())
    for rule in bit_rules:
        err, _ = sparse_case(f"4096^2 {rule.name}", packed, tile4k, 8,
                             sparse._pow2_ceil(max(count, 8) * 2), rule)
        sp_err, sp_cases = max(sp_err, err), sp_cases + 1

    def rpent(h, w):
        board = np.zeros((h, w), np.uint8)
        for dx, dy in ((1, 0), (2, 0), (0, 1), (1, 1), (1, 2)):
            board[h // 2 + dy, w // 2 + dx] = 255
        return board

    def corner_glider(h, w):
        board = np.zeros((h, w), np.uint8)
        for dy, dx in ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2)):
            board[(h - 4 + dy) % h, (w - 4 + dx) % w] = 255
        return board

    explicit = [((1, 2), 64), ((1, 8), 64), ((1, 16), 256), ((2, 16), 128), ((3, 12), 96)]
    for tile, side in explicit:
        for name, board in (("R-pentomino", rpent(side, side)),
                            ("corner glider", corner_glider(side, side))):
            packed = bitpack.pack(board, 0, dev)
            for h_turns in sorted({1, sparse.sparse_block_turns(*tile)}):
                err, run_ = sparse_case(f"{name} {side}^2 tile {tile} h={h_turns}", packed,
                                        tile, h_turns, 8, CONWAY, n_blocks=40)
                sp_err, sp_cases = max(sp_err, err), sp_cases + 1
                sp_overflows += run_.overflow
            card, cpu = (sparse.SparseBitPlane(CONWAY, tile=tile, device=d) for d in (dev, "cpu"))
            a, b = card.encode(board), cpu.encode(board)
            for n in (1, 150, 7, 300):
                a, b = card.step_n(a, n), cpu.step_n(b, n)
                check(np.array_equal(card.decode(a), cpu.decode(b))
                      and (a.count, a.steady) == (b.count, b.steady),
                      f"sparse plane {name} {side}^2 tile {tile} after n={n}: card "
                      f"{(a.count, a.steady)} cpu {(b.count, b.steady)}")
            sp_cases += 1
    check(sp_overflows >= 3, f"only {sp_overflows} sparse dispatches overflowed")
    print(f"phase 3 parity: sparse kernel equals its plain program in {sp_cases} cases "
          f"(boards, grids, blocks done, overflow, active sums and counts; 4096^2 and 16384^2 "
          f"soups with 5% and 20% of the tiles active, h = 1..8; 65536^2 and 512^2 (tiles "
          f"{tile65} and {tile512}) with live tiles on the torus's edges and corners, and "
          f"512^2's own board; 4 rules and B36/S125; the "
          f"R-pentomino and a corner glider on tiles {[t for t, _ in explicit]}, and the "
          f"plane on the card against the plane on the CPU after every step_n; "
          f"{sp_overflows} dispatches overflowed)")

    # the resident worker's strip kernel (W) against its plain version:
    # batches of K = 1, 8 and 32 turns (one launch) and 33 and 64 (chained
    # launches), widths from a ragged 100 to 16384, strips of 1, 16 and 1024
    # rows, with and without the attestation bands; strips, per-turn counts,
    # every band byte, the dirty grid, the reply's edges and, with the
    # bands, the four digest sums (modulo 65521, as they fold)
    def w_err_of(got, want, attest):
        err = max(max_abs_err(got.strip, want.strip), max_abs_err(got.counts, want.counts),
                  max_abs_err(got.dirty, want.dirty))
        if want.edges is not None:
            err = max(err, max_abs_err(got.edges, want.edges))
        if attest:
            err = max(err, max_abs_err(got.sums % strip_steps.MOD, want.sums))
            if want.bands.numel():
                err = max(err, max_abs_err(got.bands, want.bands))
        ok = (got.strip.shape == want.strip.shape and got.dirty.shape == want.dirty.shape
              and (got.edges is None) == (want.edges is None)
              and (got.bands is None) == (not attest) and (got.sums is None) == (not attest)
              and (not attest or got.bands.shape == want.bands.shape))
        return err if ok else -1

    w_err = w_cases = 0
    for k in (1, 8, 32, 33, 64):
        for width in (100, 512, 4096, 16384):
            for h in (1, 16, 1024):
                block = random_bytes((h + 2 * k, width))
                for attest in (False, True):
                    got = strip_steps.strip_steps(block, k, h, attest=attest)
                    want = strip_steps.strip_steps_plain(block, k, h, attest)
                    err = w_err_of(got, want, attest)
                    check(err == 0, f"strip kernel k={k} {h}x{width} attest={attest}: "
                                    f"max abs err {err}")
                    w_err, w_cases = max(w_err, err), w_cases + 1
                del block, got, want
    # the persistent grid's edge cases and the resident form (halos and
    # strip in separate buffers, the new strip into a second one): 20b's
    # 1024 x 4096 strip (256 wide tiles) on grids capped at 1, 7, 100 and
    # 132 CTAs (each walks several tiles, 256 no multiple of their count)
    # and on the default grid; a strip of 4 wide tiles' output (fewer than
    # the SMs) on the wide tile forced; any byte values, where the grid and
    # the sums see bytes the cells' states do not
    w_edge = 0
    for k, h, width, tile, values in ((8, 1024, 4096, None, random_bytes),
                                      (33, 1024, 4096, None, random_bytes),
                                      (8, 128, 512, strip_steps.TILE, random_bytes),
                                      (8, 1024, 4096, None, random_values),
                                      (40, 200, 1000, None, random_values)):
        block = values((h + 2 * k, width))
        want = strip_steps.strip_steps_plain(block, k, h, True)
        parts = [block[:k].clone(), block[k:k + h].clone(), block[k + h:].clone()]
        for ctas in (1, 7, 100, 132, None):
            into = strip_steps.batch_outputs(h, width, k, True, dev)
            got = strip_steps.strip_batch(*parts, k, True, into=into, tile=tile, ctas=ctas)
            err = w_err_of(got, want, True)
            check(err == 0 and got is into,
                  f"strip kernel k={k} {h}x{width} ctas={ctas}: max abs err {err}")
            w_err, w_edge = max(w_err, err), w_edge + 1
        del block, want, parts, into, got
    print(f"phase 3 parity: strip kernel equals its plain version in {w_cases} cases "
          "(k 1/8/32/33/64, widths 100/512/4096/16384, strips of 1/16/1024 rows, bands on "
          "and off: strips, per-turn counts, band bytes, dirty grids, edges, digest sums) and "
          f"{w_edge} resident-form cases (20b's strip on persistent grids of 1/7/100/132 "
          "CTAs and the default, 4 wide tiles, any byte values, k 8/33/40)")

    out_dir = REPO / "out" / "chip_smoke"

    # 5. per-turn alive counts of 512^2 for turns 1..10000, one turn per
    # chunk through Engine.run, read the way the 2-second ticker reads them.
    # No entry point runs max_chunk=1, so these one-turn launches are a
    # check of their own and stay out of the main path's counts below.
    with open(REPO / "check" / "alive" / "512x512.csv") as f:
        golden_counts = {int(r["completed_turns"]): int(r["alive_cells"])
                         for r in csv.DictReader(f)}
    seen = {}

    def record(engine, state, turn):
        seen[turn] = engine.retrieve(include_world=False).alive_count

    engine = Engine(EngineConfig(max_chunk=1, chunk_hook=record))
    board512 = read_pgm(REPO / "images" / "512x512.pgm")
    check(type(auto_plane(CONWAY, (512, 512), dev)) is FusedBitPlane,
          "512^2 routes to FusedBitPlane")
    before = whole_board.launches
    engine.run(Params(turns=10_000, image_width=512, image_height=512), board512)
    per_turn_launches = whole_board.launches - before
    bad = [t for t in range(1, 10_001) if seen.get(t) != golden_counts[t]]
    check(not bad, f"512^2 alive counts differ from check/alive at turns {bad[:5]}")
    check(per_turn_launches == 10_000, f"one launch per turn, got {per_turn_launches}")
    print("phase 5 alive: 512^2 per-turn alive counts for turns 1..10000 equal "
          f"check/alive/512x512.csv ({per_turn_launches} one-turn whole-board "
          "launches, kept out of the main path's counts)")

    # 5b. the same counts through fused_step_n(board, 1) as the engine's
    # step function, one turn per chunk, on the byte kernel the gate gives
    # 512^2, and the board after fused_step_n(board, 10000) (the K = 8
    # ladder) against the one reached one turn at a time. Checks of their
    # own, out of the main path's counts.
    def byte_route(shape):
        """``(module, name)`` of the byte kernel the step functions give a
        board of ``shape``: the whole-board one under its gate."""
        if byte_board.fits(tuple(shape), dev):
            return byte_board, "whole-board byte"
        return byte_tiled, "byte-tile"

    routed512, routed512_name = byte_route((512, 512))
    seen.clear()
    engine = Engine(EngineConfig(max_chunk=1, chunk_hook=record, step_n_fn=fused_step_n))
    before = routed512.launches
    stepwise = engine.run(Params(turns=10_000, image_width=512, image_height=512), board512)
    per_turn_launches = routed512.launches - before
    bad = [t for t in range(1, 10_001) if seen.get(t) != golden_counts[t]]
    check(not bad, f"512^2 alive counts through fused_step_n differ at turns {bad[:5]}")
    check(per_turn_launches == 10_000,
          f"one {routed512_name} launch per turn, got {per_turn_launches}")
    before = routed512.launches
    laddered = fused_step_n(torch.from_numpy(board512.copy()).to(dev), 10_000)
    ladder_launches = routed512.launches - before
    check(np.array_equal(laddered.cpu().numpy(), stepwise.world),
          "512^2 after fused_step_n(board, 10000) differs from one turn at a time")
    check(ladder_launches == 1250, f"the K = 8 ladder of 10000 turns: {ladder_launches}")
    print("phase 5b alive: 512^2 per-turn alive counts for turns 1..10000 through "
          f"fused_step_n equal check/alive/512x512.csv (10000 one-turn {routed512_name} "
          "launches), and fused_step_n(board, 10000) in 1250 8-turn launches equals the "
          "board reached one turn at a time (kept out of the main path's counts)")

    # -- the main paths, every launch counted -----------------------------
    # each path runs with every count set to 0 just before it and read just
    # after; launches made to compare a kernel with a reference stay out
    counted = {"whole_board": whole_board, "tiled": tiled, "batch_board": batch_board,
               "byte_board": byte_board, "byte_tiled": byte_tiled,
               "sparse_tiles": sparse_tiles, "strip_steps": strip_steps}
    launches = dict.fromkeys(counted, 0)
    plain = dict.fromkeys(counted, 0)

    def open_window():
        for module in counted.values():
            module.reset_counts()

    def close_window(label, expect):
        got = {name: module.launches for name, module in counted.items()}
        for name, module in counted.items():
            launches[name] += module.launches
            plain[name] += module.plain_calls
        for name in expect:
            check(got[name] > 0, f"{label}: the {name} kernel never launched")
        return got

    open_window()

    # 4. controller sessions through run(), PGM bytes against check/images
    for size in (16, 64, 512):
        for turns in (0, 1, 100):
            params = Params(turns=turns, image_width=size, image_height=size)
            result = run(params, images_dir=REPO / "images", out_dir=out_dir,
                         tick_seconds=3600)
            name = f"{size}x{size}x{turns}.pgm"
            written = (out_dir / name).read_bytes()
            golden = (REPO / "check" / "images" / name).read_bytes()
            check(written == golden, f"session {name}: PGM bytes differ from check/images")
            check(result.turns_completed == turns, f"session {name}: turns")
    print("phase 4 sessions: {16,64,512}^2 x {0,1,100} PGMs equal check/images "
          f"byte for byte ({whole_board.launches} whole-board launches)")

    # 8a. the 512^2 x 10000 session through run(): wall, and its own launches
    events = queue.Queue()
    before = whole_board.launches
    t0 = time.monotonic()
    result = run(Params(turns=10_000, image_width=512, image_height=512), events,
                 images_dir=REPO / "images", out_dir=out_dir, tick_seconds=3600)
    wall = time.monotonic() - t0
    session_launches = whole_board.launches - before
    finals = []
    while True:
        ev = events.get_nowait()
        if ev is CLOSED:
            break
        if isinstance(ev, FinalTurnComplete):
            finals.append(ev)
    check(len(finals) == 1 and len(finals[0].alive) == golden_counts[10_000],
          "512^2 x 10000 session final alive count")
    check(result.turns_completed == 10_000, "512^2 x 10000 session turns")
    print(f"timing session 512^2 x 10000 through run(): wall {wall:.3f} s, "
          f"{10_000 * 512 * 512 / wall:.4g} cell-updates/s, {session_launches} "
          f"whole-board launches ({session_launches / 10:.1f} per 1000 turns) {card_tag}")

    # 6. real size: an R-pentomino on 16384^2, 1000 turns through
    # Engine.run on the auto route, the activity-sparse plane (the sparse
    # kernel), and again on an explicit BitPlane (the tiled kernel)
    size = 16384
    plane = auto_plane(CONWAY, (size, size), dev)
    check(type(plane) is SparseBitPlane, f"16384^2 routes to SparseBitPlane, got {type(plane)}")
    seed = np.zeros(bitpack.packed_shape(size, size, plane.word_axis), np.int32)
    cx = cy = size // 2
    for dx, dy in ((1, 0), (2, 0), (0, 1), (1, 1), (1, 2)):
        x, y = cx + dx, cy + dy
        seed.view(np.uint32)[y // 32, x] |= np.uint32(1 << (y % 32))
    walls16 = {}
    for route, run_plane in (("sparse", plane), ("dense", BitPlane(CONWAY, 0, dev))):
        state = bitpack.state_from_numpy(seed, dev)
        if route == "sparse":
            state = run_plane.from_packed(state)
        torch.cuda.synchronize()
        before = {name: m.launches for name, m in counted.items()}
        eng6 = Engine(EngineConfig(final_world=False))
        t0 = time.monotonic()
        big = eng6.run(Params(turns=1000, image_width=size, image_height=size), None,
                       plane=run_plane, initial_state=state)
        big_alive = big.alive_count
        walls16[route] = (time.monotonic() - t0, {
            name: m.launches - before[name] for name, m in counted.items()
            if m.launches > before[name]})
        check(big.turns_completed == 1000, f"16384^2 turns ({route})")
        check(big_alive == 156, f"16384^2 R-pentomino alive at turn 1000 ({route}): "
                                f"{big_alive}, want 156")
        if route == "sparse":
            sparse16 = eng6.final_state()
    check(set(walls16["sparse"][1]) == {"sparse_tiles"} and set(walls16["dense"][1]) == {"tiled"},
          f"16384^2 launches: {walls16}")
    print(f"phase 6 real size: 16384^2 R-pentomino x 1000 turns through Engine.run: alive 156 "
          f"on the auto route, SparseBitPlane (wall {walls16['sparse'][0]:.3f} s, "
          f"{walls16['sparse'][1]['sparse_tiles']} sparse launches, {sparse16.count} tiles "
          f"active at the end) and on an explicit BitPlane (wall {walls16['dense'][0]:.3f} s, "
          f"{walls16['dense'][1]['tiled']} tiled launches) {card_tag}")

    close_window("in-process sessions and the 16384^2 runs",
                 ("whole_board", "tiled", "sparse_tiles"))

    # 9. a broker on loopback, in this process so its counts are readable:
    # the controller's -server sessions (the Run verb, K1 under the gate)
    server, service = broker.serve(port=0, device="cuda")
    addr = f"127.0.0.1:{server.port}"
    try:
        rpc_out = REPO / "out"
        os.chdir(REPO)  # the CLI reads images/ and writes out/ where it runs
        open_window()
        for size in (64, 512):
            for turns in (0, 1, 100):
                code = controller_main(["-server", addr, "-w", str(size), "-h", str(size),
                                        "-turns", str(turns), "-noVis"])
                name = f"{size}x{size}x{turns}.pgm"
                check(code == 0, f"-server session {name} exit {code}")
                written = (rpc_out / name).read_bytes()
                golden = (REPO / "check" / "images" / name).read_bytes()
                check(written == golden, f"-server session {name}: PGM bytes differ")
        got = close_window("-server sessions", ("whole_board",))
        print("phase 9 rpc: -server sessions {64,512}^2 x {0,1,100} through a broker on "
              f"loopback equal check/images byte for byte ({got['whole_board']} "
              "whole-board launches)")

        # 10. 256 concurrent SessionRuns of 128^2 (budgets 1..1000), with
        # tagged retrieves while they run; checked after the window against
        # sequential whole-board runs
        n_sess, side = 256, 128
        boards = np.where(rng.random((n_sess, side, side)) < 0.3, 255, 0).astype(np.uint8)
        budgets = [1 + (999 * i) // (n_sess - 1) for i in range(n_sess)]
        results, errors, snaps = {}, [], []
        all_done = threading.Event()

        def session(i):
            rb = RemoteBroker(addr)
            try:
                results[i] = rb.session_run(
                    Params(turns=budgets[i], image_width=side, image_height=side),
                    boards[i], session_id=i + 1, timeout=600,
                )
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append((i, e))
            finally:
                rb.close()

        def watch(tag_of):
            rb = RemoteBroker(addr)
            try:
                k = 0
                while not all_done.is_set():
                    tag = tag_of(k)
                    k += 1
                    try:
                        snap = rb.retrieve(include_world=True, session_id=tag)
                    except RpcError:
                        continue  # not admitted yet
                    snaps.append((tag - 1, snap))
                    time.sleep(0.001)
            except BaseException as e:  # noqa: BLE001
                errors.append(("watch", e))
            finally:
                rb.close()

        open_window()
        t0 = time.monotonic()
        threads = [threading.Thread(target=session, args=(i,)) for i in range(n_sess)]
        for t in threads:
            t.start()
        # one watcher cycles through every session; two more ask the 64
        # longest budgets, which are in flight the longest, so that some
        # retrieves land mid-flight however slowly the host serves them
        watchers = [threading.Thread(target=watch, args=(lambda k: 1 + (37 * k) % n_sess,))]
        watchers += [threading.Thread(target=watch, args=(lambda k, j=j: n_sess - (2 * k + j) % 64,))
                     for j in (0, 1)]
        for w in watchers:
            w.start()
        for t in threads:
            t.join(600)
        sessions_wall = time.monotonic() - t0
        all_done.set()
        for w in watchers:
            w.join(60)
        got = close_window("256 SessionRuns", ("batch_board",))
        check(not errors, f"SessionRun failures: {errors[:3]}")
        check(not any(t.is_alive() for t in threads + watchers),
              "SessionRun threads still running")
    finally:
        service.shutdown()

    # the reference runs no CUDA kernel: the plain torch turn
    # (bitpack.bit_step_n_batch) walks all 256 boards one turn at a time and
    # is read at each turn a session finished or a checked retrieve landed
    mid = [(i, sn) for i, sn in snaps if 0 < sn.turns_completed < budgets[i]]
    checked = snaps[:: max(1, len(snaps) // 200)] + mid[:50]
    wanted = {}
    for i, turn in [(i, budgets[i]) for i in range(n_sess)] + [
            (i, sn.turns_completed) for i, sn in checked]:
        wanted.setdefault(turn, set()).add(i)
    walk = bitpack.pack_batch(boards, 0, dev)
    reference = {}
    for turn in range(max(wanted) + 1):
        if turn:
            walk = bitpack.bit_step_n_batch(walk, 1)
        if turn in wanted:
            rows = sorted(wanted[turn])
            read = bitpack.unpack_batch(walk[rows], 0).cpu().numpy()
            reference.update(((i, turn), read[j]) for j, i in enumerate(rows))

    for i in range(n_sess):
        check(results[i].turns_completed == budgets[i], f"SessionRun {i} turns")
        check(np.array_equal(results[i].world, reference[i, budgets[i]]),
              f"SessionRun {i} (budget {budgets[i]}) differs from the plain reference")
    for i, snap in checked:
        want = reference[i, snap.turns_completed]
        check(np.array_equal(snap.world, want) and
              snap.alive_count == int(np.count_nonzero(want)),
              f"tagged retrieve of session {i + 1} at turn {snap.turns_completed}")
    check(mid, "no tagged retrieve landed mid-flight")
    print(f"phase 10 SessionRun: {n_sess} concurrent 128^2 sessions over loopback, "
          f"budgets 1..1000, each equal to the plain torch turn's board at its "
          f"budget; {len(snaps)} tagged "
          f"retrieves ({len(mid)} mid-flight) equal the plain board at their turn; "
          f"wall {sessions_wall:.3f} s, {got['batch_board']} batched launches {card_tag}")

    # 11. the sessions bench shape (bench.py config 8): 1000 x 128^2 x 100
    # turns, seed 7, an all-dead and a lone-glider universe in the mix
    B8, side8, turns8 = 1000, 128, 100
    gen7 = np.random.default_rng(7)
    boards8 = np.where(gen7.random((B8, side8, side8)) < 0.3, 255, 0).astype(np.uint8)
    boards8[0] = 0
    boards8[1] = 0
    for y, x in ((1, 2), (2, 3), (3, 1), (3, 2), (3, 3)):
        boards8[1, y, x] = 255
    plane1 = auto_plane(CONWAY, (side8, side8), dev)
    check(type(plane1) is FusedBitPlane, "128^2 routes to FusedBitPlane")
    check(type(auto_batch_plane(CONWAY, (side8, side8), dev)) is BatchBitPlane,
          "128^2 batches route to BatchBitPlane")

    def run_sequential():
        out = []
        for i in range(B8):
            state, _ = plane1.step_n_counted(plane1.encode(boards8[i]), turns8)
            out.append(plane1.decode(state))
        return out

    def run_batch():
        table = SessionTable(CONWAY, (side8, side8), capacity=B8, device=dev)
        sessions = [table.admit(boards8[i], turns8) for i in range(B8)]
        while table.advance():
            pass
        return sessions

    run_sequential()  # warm: both sides are timed at steady state
    run_batch()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    seq8 = run_sequential()
    seq_wall = time.monotonic() - t0
    open_window()
    t0 = time.monotonic()
    sessions8 = run_batch()
    batch_wall = time.monotonic() - t0
    got = close_window("1000 x 128^2 sessions", ("batch_board",))
    # the plain torch turn, which runs no CUDA kernel, on the same batch:
    # its boards and row counts hold the sessions and, in the timing below,
    # the timed K2 launch
    p8 = bitpack.pack_batch(boards8, 0, dev)
    plain8, plain8_counts = batch_board.step_n_plain(p8, turns8)
    plain8_boards = bitpack.unpack_batch(plain8, 0).cpu().numpy()
    for i in range(B8):
        check(sessions8[i].turns_done == turns8, f"config-8 universe {i} turns")
        check(np.array_equal(sessions8[i].result, seq8[i]),
              f"config-8 universe {i} differs from its sequential run")
        check(np.array_equal(sessions8[i].result, plain8_boards[i]),
              f"config-8 universe {i} differs from the plain torch turn")
    check(not np.any(seq8[0]) and np.count_nonzero(seq8[1]) == 5,
          "config-8 dead universe and glider")
    print(f"phase 11 sessions bench shape: 1000 x 128^2 x 100 turns through SessionTable "
          f"equal 1000 sequential FusedBitPlane runs and the plain torch turn on the "
          f"whole batch; batched {B8 / batch_wall:.6g} "
          f"sessions/s (wall {batch_wall:.4f} s, {got['batch_board']} batched launches), "
          f"sequential {B8 / seq_wall:.6g} sessions/s (wall {seq_wall:.4f} s) {card_tag}")

    # 12. the engine's step-function override: the nine golden sessions
    # through pallas_step_n_fn (K5 under its gate in one launch a chunk, K6
    # in launches of 32 turns past it) and through fused_step_n (K5's ladder
    # under the gate, K6's past it), PGM bytes against check/images; then
    # the 512^2 x 10000 session through fused_step_n. Which kernel a size
    # reaches is byte_board.fits's to say.
    open_window()
    step_fns = {"pallas_step_n_fn": pallas_step_n_fn(CONWAY), "fused_step_n": fused_step_n}
    by_session = {}
    for fn_name, step_fn in step_fns.items():
        for size in (16, 64, 512):
            for turns in (0, 1, 100):
                before = (byte_board.launches, byte_tiled.launches)
                run(Params(turns=turns, image_width=size, image_height=size),
                    images_dir=REPO / "images", out_dir=out_dir, tick_seconds=3600,
                    engine_config=EngineConfig(step_n_fn=step_fn))
                name = f"{size}x{size}x{turns}.pgm"
                written = (out_dir / name).read_bytes()
                golden = (REPO / "check" / "images" / name).read_bytes()
                check(written == golden,
                      f"{fn_name} session {name}: PGM bytes differ from check/images")
                by_session[fn_name, size, turns] = (byte_board.launches - before[0],
                                                    byte_tiled.launches - before[1])
    for (fn_name, size, turns), (k5, k6) in by_session.items():
        on_k5 = byte_route((size, size))[0] is byte_board
        if not turns:
            check(k5 == k6 == 0, f"{fn_name} {size}^2 x {turns}: K5 {k5}, K6 {k6}")
        elif on_k5:
            check(k5 > 0 and k6 == 0, f"{fn_name} {size}^2 x {turns}: K5 {k5}, K6 {k6}")
        else:
            check(k6 > 0 and k5 == 0, f"{fn_name} {size}^2 x {turns}: K5 {k5}, K6 {k6}")
    sizes_on = {m: [size for size in (16, 64, 512) if byte_route((size, size))[0] is m]
                for m in (byte_board, byte_tiled)}
    print("phase 12 step functions: {16,64,512}^2 x {0,1,100} PGMs through "
          "pallas_step_n_fn and fused_step_n equal check/images byte for byte "
          f"({byte_board.launches} whole-board byte launches at {sizes_on[byte_board]}, "
          f"{byte_tiled.launches} byte-tile launches at {sizes_on[byte_tiled]})")
    # a host-bound wall: collect the earlier phases' garbage first, so a
    # full collection of it does not land inside this session
    gc.collect()
    before = routed512.launches
    t0 = time.monotonic()
    result = run(Params(turns=10_000, image_width=512, image_height=512),
                 images_dir=REPO / "images", out_dir=out_dir, tick_seconds=3600,
                 engine_config=EngineConfig(step_n_fn=fused_step_n))
    fused_wall = time.monotonic() - t0
    fused_session_launches = routed512.launches - before
    check(result.turns_completed == 10_000 and
          result.alive_count == golden_counts[10_000],
          "512^2 x 10000 session through fused_step_n: final alive count")
    print(f"timing session 512^2 x 10000 through fused_step_n: wall {fused_wall:.3f} s, "
          f"{10_000 * 512 * 512 / fused_wall:.4g} cell-updates/s, "
          f"{fused_session_launches} {routed512_name} launches {card_tag}")

    # 13. boards without a golden image, from the seed, through Engine.run
    # with fused_step_n (the K = 8 ladder) and with pallas_step_n_fn, each
    # equal to the same board through the auto plane (the bitboard kernels):
    # the largest square under K5's gate, which K5 steps on a cluster, and
    # 4096^2 past it, so that the byte tiles stay on a driven path wherever
    # the gate stands.
    check(byte_route((gate_side, gate_side))[0] is byte_board
          and byte_board.cluster_size((gate_side, gate_side)) > 1,
          f"{gate_side}^2 is under K5's gate and takes a cluster")
    check(byte_route((4096, 4096))[0] is byte_tiled, "4096^2 is past K5's gate")
    for side, turns in ((gate_side, 1000), (4096, 300)):
        routed, routed_name = byte_route((side, side))
        board = np.where(rng.random((side, side)) < 0.35, 255, 0).astype(np.uint8)
        params = Params(turns=turns, image_width=side, image_height=side)
        before = whole_board.launches + tiled.launches
        reference = Engine(EngineConfig()).run(params, board)
        check(whole_board.launches + tiled.launches > before,
              f"the {side}^2 reference ran on a bitboard kernel")
        walls = {}
        for fn_name, step_fn in step_fns.items():
            before = {m: m.launches for m in (byte_board, byte_tiled)}
            torch.cuda.synchronize()
            t0 = time.monotonic()
            got = Engine(EngineConfig(step_n_fn=step_fn)).run(params, board)
            walls[fn_name] = (time.monotonic() - t0, routed.launches - before[routed])
            check(got.turns_completed == turns and np.array_equal(got.world, reference.world)
                  and got.alive_count == reference.alive_count,
                  f"{side}^2 x {turns} through {fn_name} differs from the bitboard plane")
            other_module = byte_tiled if routed is byte_board else byte_board
            check(walls[fn_name][1] > 0 and other_module.launches == before[other_module],
                  f"{side}^2 through {fn_name}: {walls[fn_name][1]} {routed_name} launches, "
                  f"{other_module.launches - before[other_module]} of the other byte kernel")
        print(f"phase 13 {'under' if routed is byte_board else 'past'} the gate: "
              f"{side}^2 x {turns} turns through Engine.run with "
              + " and ".join(f"{name} ({launched} {routed_name} launches, wall {wall:.3f} s)"
                             for name, (wall, launched) in walls.items())
              + f" equal the auto plane's board (alive {reference.alive_count}) {card_tag}")
        del board, reference, got
    close_window("step-function sessions", ("byte_board", "byte_tiled"))

    # 14. periodic checkpoints and resume at 512^2, in chunks of 256 turns:
    # growth ends with the first chunk, so every crossing of a multiple of
    # 1000 lands on a pipelined chunk (a CUDA event, no synchronise) and
    # each checkpoint must hold the committed board of its turn, which the
    # next chunk's hook reads back against check/alive. The session quits
    # after the turn-5000 crossing, at 5120. On the auto plane (K1) the checkpoints are
    # packed and resume through Engine.run; through fused_step_n (the byte
    # tiles) they are byte checkpoints, and the CLI's -resume continues the
    # last one in a process of its own.
    ck_dir = out_dir / "ckpt"
    ck_dir.mkdir(parents=True, exist_ok=True)

    def checkpointed_512(name, **config):
        path = ck_dir / f"{name}.npz"
        path.unlink(missing_ok=True)
        read = {}

        def read_back(engine, state, turn):
            if path.exists():
                with np.load(path) as data:
                    packed = "packed" in data
                if packed:
                    packed_ck, turn_ck, _, _ = load_packed_checkpoint(path)
                    read[turn_ck] = int(np.unpackbits(packed_ck.view(np.uint8)).sum())
                else:
                    board_ck, turn_ck, _ = load_verified_checkpoint(path)
                    read[turn_ck] = int(np.count_nonzero(board_ck))
            if engine is not None and turn >= 5000:
                engine.quit()

        engine = Engine(EngineConfig(checkpoint_every=1000, min_chunk=256, max_chunk=256,
                                     checkpoint_path=str(path), chunk_hook=read_back,
                                     **config))
        res = engine.run(Params(turns=10_000, image_width=512, image_height=512), board512)
        read_back(None, None, 0)  # the last checkpoint, written after the last hook
        check(res.checkpoint_error is None, f"{name}: {res.checkpoint_error}")
        check(res.turns_completed == 5120, f"{name} quit at {res.turns_completed}")
        check(sorted(read) == [1024, 2048, 3072, 4096, 5120],
              f"{name} checkpoints read {sorted(read)}")
        bad = [t for t, count in read.items() if count != golden_counts[t]]
        check(not bad, f"{name}: checkpoints at {bad} differ from check/alive")
        return path, res.turns_completed

    open_window()
    packed_ck, quit_turn = checkpointed_512("auto_512")
    packed_words, ck_turn, ck_rule, ck_axis = load_packed_checkpoint(packed_ck)
    check(ck_turn == quit_turn == 5120, f"last packed checkpoint at {ck_turn}, quit {quit_turn}")
    resumed = Engine(EngineConfig(final_world=False)).run(
        Params(turns=10_000, image_width=512, image_height=512), None,
        plane=FusedBitPlane(ck_rule, ck_axis, dev),
        initial_state=bitpack.state_from_numpy(packed_words, dev), initial_turn=ck_turn)
    check(resumed.alive_count == golden_counts[10_000],
          f"packed resume from {ck_turn}: alive {resumed.alive_count}")
    byte_ck, byte_turn = checkpointed_512("fused_512", step_n_fn=fused_step_n)
    check(load_verified_checkpoint(byte_ck)[1] == byte_turn == 5120, "byte checkpoint turn")
    got = close_window("checkpointed 512^2 sessions", ("whole_board", "byte_tiled"))
    t0 = time.monotonic()
    cli = subprocess.run(
        [sys.executable, "-m", "gol_distributed_final_tpu_torch", "-w", "512", "-h", "512",
         "-turns", "10000", "-noVis", "-resume", str(byte_ck)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)
    cli_wall = time.monotonic() - t0
    check(cli.returncode == 0, f"-resume CLI exit {cli.returncode}: {cli.stderr[-2000:]}")
    resumed_pgm = read_pgm(REPO / "out" / "512x512x10000.pgm")
    check(int(np.count_nonzero(resumed_pgm)) == golden_counts[10_000],
          "-resume CLI from turn 5120: alive at 10000 differs from check/alive")
    print(f"phase 14 resume: 512^2 in chunks of 256 with a checkpoint every 1000 turns, quit "
          f"past 5000: the checkpoints at 1024..5120 read back equal check/alive, both on the "
          f"auto plane (packed, {got['whole_board']} whole-board launches) and through "
          f"fused_step_n (bytes, {got['byte_tiled']} byte-tile launches); the turn-5120 packed file "
          f"resumed through Engine.run and the byte one through `-resume` in a process of its "
          f"own (wall {cli_wall:.2f} s) reach check/alive's {golden_counts[10_000]} at 10000")

    # 14b. a turn-50 checkpoint resumed to 100 through the CLI in this
    # process, and over two brokers started with -resume (the second with
    # -ckpt-keep 2 and its newest generation corrupt): check/images bytes
    world50 = Engine(EngineConfig()).run(
        Params(turns=50, image_width=512, image_height=512), board512).world
    ck50 = save_checkpoint(ck_dir / "s50.npz", world50, 50)
    chain = ck_dir / "chain.npz"
    chain.write_bytes(ck50.read_bytes())
    rotate_generations(chain, keep=2)
    chain.write_bytes(b"a corrupt newest generation")
    check(generation_path(chain, 1).exists(), "generation 1 of the chain")
    golden100 = (REPO / "check" / "images" / "512x512x100.pgm").read_bytes()
    os.chdir(REPO)  # the CLI writes out/ where it runs
    open_window()
    code = controller_main(["-w", "512", "-h", "512", "-turns", "100", "-noVis",
                            "-resume", str(ck50)])
    check(code == 0 and (REPO / "out" / "512x512x100.pgm").read_bytes() == golden100,
          "-resume from turn 50: PGM bytes differ from check/images")
    in_process = whole_board.launches
    for flags in (["-resume", str(ck50)], ["-resume", str(chain), "-ckpt-keep", "2"]):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        addr = f"127.0.0.1:{port}"
        served = threading.Thread(target=broker.main, args=(["-port", str(port), *flags],),
                                  daemon=True)
        served.start()
        deadline = time.monotonic() + 120
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                check(served.is_alive() and time.monotonic() < deadline,
                      f"broker {flags} did not start listening")
                time.sleep(0.05)
        (REPO / "out" / "512x512x100.pgm").unlink()
        code = controller_main(["-server", addr, "-w", "512", "-h", "512", "-turns", "100",
                                "-noVis"])
        check(code == 0 and (REPO / "out" / "512x512x100.pgm").read_bytes() == golden100,
              f"-server session on a broker with {flags}: PGM bytes differ")
        rb = RemoteBroker(addr)
        rb.super_quit()
        rb.close()
        served.join(60)
        check(not served.is_alive(), f"broker {flags} did not stop")
    got = close_window("resumed 512^2 sessions", ("whole_board",))
    print(f"phase 14b resume: a turn-50 checkpoint resumed to 100 through `-resume` in "
          f"process ({in_process} whole-board launches) and over brokers started with "
          f"`-resume` and with `-resume -ckpt-keep 2` past a corrupt newest generation "
          f"({got['whole_board'] - in_process} launches) equal check/images/512x512x100.pgm "
          "byte for byte")

    # 15. a packed checkpoint at 16384^2: the R-pentomino's periodic
    # checkpoint at turn 500, loaded and run on to 1000 (156 alive)
    size16 = 16384
    plane16 = BitPlane(CONWAY, 0, dev)
    ck16 = ck_dir / "packed_16384.npz"
    ck16.unlink(missing_ok=True)
    open_window()
    eng16 = Engine(EngineConfig(final_world=False, checkpoint_every=500,
                                checkpoint_path=str(ck16)))
    half = eng16.run(Params(turns=500, image_width=size16, image_height=size16), None,
                     plane=plane16,
                     initial_state=bigboard.seed_packed(size16, bigboard.r_pentomino(size16)))
    check(half.checkpoint_error is None, f"16384^2 checkpoint: {half.checkpoint_error}")
    words16, turn16, rule16, axis16 = load_packed_checkpoint(ck16)
    check((turn16, rule16.rulestring, axis16) == (500, "B3/S23", 0), "16384^2 checkpoint")
    state16 = bitpack.state_from_numpy(words16, dev)
    check(torch.equal(state16, eng16.final_state()), "16384^2 checkpoint equals the state")
    eng16b = Engine(EngineConfig(final_world=False))
    full16 = eng16b.run(Params(turns=1000, image_width=size16, image_height=size16), None,
                        plane=plane16, initial_state=state16, initial_turn=500)
    check(full16.turns_completed == 1000 and full16.alive_count == 156,
          f"16384^2 resumed from 500: alive {full16.alive_count}, want 156")
    final16 = eng16b.final_state()
    got = close_window("16384^2 packed checkpoint", ("tiled",))
    t0 = time.monotonic()
    save_packed_checkpoint(ck_dir / "timed.npz", final16, 1000)
    write16 = time.monotonic() - t0
    print(f"phase 15 packed checkpoint: the 16384^2 R-pentomino's checkpoint at turn 500 "
          f"loads equal to the state and runs on to 156 alive at 1000 ({got['tiled']} tiled "
          f"launches); one packed write takes {write16:.3f} s {card_tag}")

    # 16. BASELINE config 5: the 65536^2 R-pentomino, 1000 turns, through
    # run_big_board and through the bigboard CLI (no PGM: it would be a 4
    # GiB raster), 125 tiled launches of 8 turns each; the window around
    # the centre equals the 16384^2 run's
    size65 = 65536
    open_window()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    alive65 = bigboard.run_big_board(size65, 1000, None, cells=bigboard.r_pentomino(size65))
    wall65 = time.monotonic() - t0
    launches65 = tiled.launches
    check(alive65 == 156, f"65536^2 R-pentomino alive at turn 1000: {alive65}, want 156")
    check(launches65 == 125, f"65536^2 x 1000: {launches65} tiled launches, want 125")
    printed = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(printed):
        code = bigboard.main(["-size", str(size65), "-turns", "1000", "-out", ""])
    cli65_wall = time.monotonic() - t0
    check(code == 0 and printed.getvalue().strip() == "alive 156",
          f"bigboard CLI at 65536^2: {printed.getvalue().strip()!r}")
    check(tiled.launches == 250, f"the CLI's tiled launches: {tiled.launches - 125}")
    state65 = plane16.step_n(bigboard.seed_packed(size65, bigboard.r_pentomino(size65)), 1000)
    got = close_window("65536^2 R-pentomino", ("tiled",))
    win = 1024
    w65 = bigboard.decode_window(state65, size65 // 2 - win // 2, size65 // 2 - win // 2,
                                 win, win)
    w16 = bigboard.decode_window(final16, size16 // 2 - win // 2, size16 // 2 - win // 2,
                                 win, win)
    check(np.array_equal(w65, w16) and np.count_nonzero(w65) == 156,
          "65536^2 centre window differs from the 16384^2 run's")
    t0 = time.monotonic()
    ck65 = save_packed_checkpoint(ck_dir / "packed_65536.npz", state65, 1000)
    write65 = time.monotonic() - t0
    words65, turn65, _, _ = load_packed_checkpoint(ck65)
    check(turn65 == 1000 and torch.equal(bitpack.state_from_numpy(words65, dev), state65),
          "65536^2 packed checkpoint round trip")
    del words65
    ck65.unlink()
    print(f"phase 16 config 5: 65536^2 R-pentomino x 1000 turns: alive 156 through "
          f"run_big_board (wall {wall65:.3f} s, {launches65} tiled launches) and the bigboard "
          f"CLI (wall {cli65_wall:.3f} s); its {win}^2 centre window equals the 16384^2 "
          f"run's ({got['tiled']} tiled launches in all); one packed checkpoint write takes "
          f"{write65:.3f} s {card_tag}")

    # 16b. the same board on the activity-sparse plane, adopted with
    # SparseBitPlane.from_packed(seed_packed(...)): 1000 turns in one
    # step_n, 156 alive, its centre window equal to the dense run's
    open_window()
    plane65 = SparseBitPlane(CONWAY, device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    sparse65 = plane65.step_n(
        plane65.from_packed(bigboard.seed_packed(size65, bigboard.r_pentomino(size65))), 1000)
    alive_s65 = plane65.alive_count(sparse65)
    wall_s65 = time.monotonic() - t0
    got = close_window("65536^2 sparse R-pentomino", ("sparse_tiles",))
    check(alive_s65 == 156, f"65536^2 sparse R-pentomino alive at turn 1000: {alive_s65}")
    ws65 = bigboard.decode_window(sparse65.packed, size65 // 2 - win // 2,
                                  size65 // 2 - win // 2, win, win)
    check(np.array_equal(ws65, w65), "65536^2 sparse centre window differs from the dense run's")
    print(f"phase 16b config 5 sparse: 65536^2 R-pentomino x 1000 turns through "
          f"SparseBitPlane.from_packed(seed_packed(...)): alive 156, wall {wall_s65:.3f} s, "
          f"{got['sparse_tiles']} sparse launches, {sparse65.count} of "
          f"{(2048 // 8) * (65536 // 128)} tiles active at the end; its {win}^2 centre window "
          f"equals the dense run's {card_tag}")

    # 17. a 16384^2 big_session: its streamed PGM, read back packed, equals
    # the engine's final state
    open_window()
    events = queue.Queue()
    eng_s = Engine(EngineConfig(final_world=False))
    t0 = time.monotonic()
    res_s = bigboard.big_session(size16, 1000, cells=bigboard.r_pentomino(size16),
                                 engine=eng_s, events=events, out_dir=out_dir,
                                 tick_seconds=3600)
    session16_wall = time.monotonic() - t0
    finals = []
    while True:
        ev = events.get_nowait()
        if ev is CLOSED:
            break
        if isinstance(ev, FinalTurnComplete):
            finals.append(ev)
    check(res_s.turns_completed == 1000 and len(finals) == 1 and len(finals[0].alive) == 156,
          "16384^2 big_session: final alive")
    big_pgm = out_dir / f"{size16}x{size16}x1000.pgm"
    check(torch.equal(bigboard.load_packed_from_pgm(big_pgm), eng_s.final_state()),
          "16384^2 big_session: the streamed PGM differs from the final state")
    big_pgm.unlink()
    got = close_window("16384^2 big_session", ("tiled",))
    print(f"phase 17 big_session: 16384^2 R-pentomino x 1000 turns, 156 alive, its streamed "
          f"PGM read back packed equals the final state (wall {session16_wall:.3f} s with the "
          f"PGM, {got['tiled']} tiled launches) {card_tag}")

    # 18. a sparse run with periodic checkpoints, resumed to its golden:
    # 512^2 on an explicit SparseBitPlane to turn 5000 in chunks of 256 with
    # a checkpoint every 1000 turns. Its state is no int32 tensor, so the
    # checkpoints are byte files; each is read back against check/alive,
    # the one the early exit writes when the board turns steady among them
    # (the jump crosses the rest at once), and the turn-5000 file resumes
    # on a SparseBitPlane to check/alive's count at 10000.
    sparse_ck = ck_dir / "sparse_512.npz"
    sparse_ck.unlink(missing_ok=True)
    sparse_read = {}

    def sparse_read_back(engine, state, turn):
        if sparse_ck.exists():
            board_ck, turn_ck, _ = load_verified_checkpoint(sparse_ck)
            sparse_read[turn_ck] = int(np.count_nonzero(board_ck))

    open_window()
    eng18 = Engine(EngineConfig(checkpoint_every=1000, min_chunk=256, max_chunk=256,
                                checkpoint_path=str(sparse_ck), chunk_hook=sparse_read_back,
                                plane=SparseBitPlane(CONWAY, device=dev)))
    res18 = eng18.run(Params(turns=5000, image_width=512, image_height=512), board512)
    sparse_read_back(None, None, 0)  # the last checkpoint, written after the last hook
    steady18 = eng18.final_state().steady
    check(res18.checkpoint_error is None and res18.turns_completed == 5000,
          f"sparse 512^2: {res18.turns_completed} turns, {res18.checkpoint_error}")
    bad = [t for t, count in sparse_read.items() if count != golden_counts[t]]
    check(5000 in sparse_read and not bad, f"sparse checkpoints {sorted(sparse_read)}, "
                                           f"differing from check/alive at {bad}")
    board_ck, turn_ck, rule_ck = load_verified_checkpoint(sparse_ck)
    resumed = Engine(EngineConfig()).run(
        Params(turns=10_000, image_width=512, image_height=512), board_ck,
        plane=SparseBitPlane(rule_ck, device=dev), initial_turn=turn_ck)
    check(resumed.alive_count == golden_counts[10_000],
          f"sparse resume from {turn_ck}: alive {resumed.alive_count}")
    got = close_window("checkpointed sparse 512^2 session", ())
    print(f"phase 18 sparse resume: 512^2 on SparseBitPlane to 5000 in chunks of 256 with a "
          f"checkpoint every 1000 turns: the byte checkpoints at {sorted(sparse_read)} read "
          f"back equal check/alive (the state ends {steady18 or 'not steady'}), and the "
          f"turn-5000 file resumed on SparseBitPlane reaches check/alive's "
          f"{golden_counts[10_000]} at 10000 (launches {got})")

    # 19. a controller session without -noVis: 512^2 x 100 through the CLI
    # with the visualiser loop on the window make_window gives this host
    # (headless unless it has libSDL2 and a display); the window's pixels
    # at the end equal FinalTurnComplete's alive cells and the PGM is the
    # golden one. The PGM of 512^2 is under the native codec's 1 MiB
    # threshold, so the codec is held against the Python one on that board
    # and writes a 2048^2 board through write_pgm, read back by numpy.
    from gol_distributed_final_tpu_torch.events import FinalTurnComplete as FinalEvent
    from gol_distributed_final_tpu_torch.io import native
    from gol_distributed_final_tpu_torch.io.pgm import write_pgm
    from gol_distributed_final_tpu_torch.viz import loop as viz_loop

    windows, finals = [], []
    real_make_window, real_viz_run = viz_loop.make_window, viz_loop.run

    def capture_window(*args, **kwargs):
        windows.append(real_make_window(*args, **kwargs))
        return windows[-1]

    def capture_finals(params, events, keypresses=None, **kwargs):
        real_get = events.get

        def get(*a, **k):
            ev = real_get(*a, **k)
            if isinstance(ev, FinalEvent):
                finals.append(ev)
            return ev

        events.get = get
        return real_viz_run(params, events, keypresses, **kwargs)

    viz_loop.make_window = capture_window
    gol_viz = sys.modules["gol_distributed_final_tpu_torch.viz"]
    gol_viz.run = capture_finals
    (REPO / "out" / "512x512x100.pgm").unlink(missing_ok=True)
    open_window()
    t0 = time.monotonic()
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            code = controller_main(["-w", "512", "-h", "512", "-turns", "100"])
    finally:
        viz_loop.make_window, gol_viz.run = real_make_window, real_viz_run
    vis_wall = time.monotonic() - t0
    got = close_window("512^2 session with the visualiser", ())
    check(code == 0 and (REPO / "out" / "512x512x100.pgm").read_bytes() == golden100,
          "512^2 x 100 without -noVis: PGM bytes differ from check/images")
    check(len(windows) == 1 and len(finals) == 1, f"{len(windows)} windows, {len(finals)} finals")
    window = windows[0]
    check(window.count_pixels() == len(finals[0].alive) == int(np.count_nonzero(
        read_pgm(REPO / "check" / "images" / "512x512x100.pgm"))),
        f"window pixels {window.count_pixels()} against {len(finals[0].alive)} alive")
    check(window.frames_rendered == 100, f"{window.frames_rendered} frames rendered")
    check(native.available(), "the native PGM codec did not build")
    used = native.used
    native_copy = out_dir / "native_512.pgm"
    check(native.write_board(native_copy, read_pgm(REPO / "out" / "512x512x100.pgm"))
          and native_copy.read_bytes() == golden100, "the native codec's 512^2 bytes differ")
    big_board = np.where(rng.random((2048, 2048)) < 0.35, 255, 0).astype(np.uint8)
    write_pgm(out_dir / "native_2048.pgm", big_board)
    check(np.array_equal(read_pgm(out_dir / "native_2048.pgm"), big_board),
          "a 2048^2 board through the native codec")
    check(native.used - used == 2, f"the native codec served {native.used - used} of 2 writes")
    print(f"phase 19 visualiser: 512^2 x 100 through the CLI without -noVis on a "
          f"{type(window).__name__} window: PGM equals check/images byte for byte, "
          f"{window.count_pixels()} pixels lit = FinalTurnComplete's alive cells, "
          f"{window.frames_rendered} frames, wall {vis_wall:.2f} s (launches {got}); the "
          f"native codec built in {native.BUILD_DIR} writes the golden bytes and served a "
          f"2048^2 write")

    # the two PGM codecs on this host: write_pgm, whose native route starts
    # at 1 MiB, against the same call with that threshold lifted past every
    # board (the numpy codec), and read_pgm (numpy at every size) against
    # the native codec's read of the same rows; best of three, alternating;
    # both write the same bytes and fsync
    from gol_distributed_final_tpu_torch.io import pgm as pgm_mod

    def codec_times(board, path, numpy_codec):
        saved = pgm_mod._NATIVE_THRESHOLD_BYTES
        if numpy_codec:
            pgm_mod._NATIVE_THRESHOLD_BYTES = 1 << 62
        try:
            used = native.used
            t0 = time.monotonic()
            write_pgm(path, board)
            t1 = time.monotonic()
            if numpy_codec:
                back = read_pgm(path)
            else:
                w, h, _, offset = native.read_header(path)
                back = native.read_rows(path, offset, w, 0, h)
            t2 = time.monotonic()
        finally:
            pgm_mod._NATIVE_THRESHOLD_BYTES = saved
        check(back is not None and np.array_equal(back, board),
              f"{path.name}: the board read back differs")
        check(native.used - used == (0 if numpy_codec else 2),
              f"{path.name}: the native codec served {native.used - used} calls")
        return t1 - t0, t2 - t1, path.read_bytes() if board.nbytes <= 1 << 24 else None

    print("timing PGM codecs, write_pgm and a whole read (s, best of 3; write includes "
          "fsync):")
    for side in (1024, 4096, 16384):
        board = np.where(rng.random((side, side)) < 0.35, 255, 0).astype(np.uint8)
        best = {"native": [1e9, 1e9], "numpy": [1e9, 1e9]}
        files = {}
        for _ in range(3):
            for codec in ("native", "numpy"):
                path = out_dir / f"codec_{codec}_{side}.pgm"
                w_s, r_s, data = codec_times(board, path, codec == "numpy")
                best[codec] = [min(best[codec][0], w_s), min(best[codec][1], r_s)]
                files[codec] = data
                path.unlink()
        check(files["native"] == files["numpy"], f"{side}^2: the codecs' bytes differ")
        (nw, nr), (pw, pr) = best["native"], best["numpy"]
        print(f"  {side}^2 ({board.nbytes} B): native write {nw:.4f} read {nr:.4f}, numpy "
              f"write {pw:.4f} read {pr:.4f}; numpy/native {pw / nw:.3g}x write, "
              f"{pr / nr:.3g}x read (the host of {card_tag})")
        del board

    # 20. a workers cluster through the CLIs on the card: four worker
    # processes (-device cuda; GOL_WORKER_FUSED=on sends every strip batch
    # to the strip kernel) and a workers broker on the resident wire at
    # K = 8 serve the controller's -server sessions {64,512}^2 x {0,1,100}
    # and a 512^2 x 100 session whose 2-second ticks come every 0.02 s;
    # then brokers over the same workers on -wire haloed and on -grid 2x2
    # serve a 512^2 x 100 session each, and SuperQuit takes the cluster
    # down. The workers' launches are their own processes' (20b counts W).
    from gol_distributed_final_tpu_torch.events import AliveCellsCount

    with open(REPO / "check" / "alive" / "64x64.csv") as f:
        golden64 = {int(r["completed_turns"]): int(r["alive_cells"])
                    for r in csv.DictReader(f)}
    golden_alive = {64: golden64, 512: golden_counts}
    first_ticks = {64: 2819, 512: int(np.count_nonzero(board512))}
    procs = []
    t0 = time.monotonic()
    try:
        wprocs = [Proc(["-m", "gol_distributed_final_tpu_torch.rpc.worker", "-port", "0",
                        "-device", "cuda"], env={"GOL_WORKER_FUSED": "on"})
                  for _ in range(4)]
        procs += wprocs
        roster = ",".join(f"127.0.0.1:{w.port('worker listening on :')}" for w in wprocs)
        worker_start = time.monotonic() - t0

        def cli_broker(*flags):
            proc = Proc(["-m", "gol_distributed_final_tpu_torch.rpc.broker", "-port", "0",
                         "-backend", "workers", "-workers", roster, *flags])
            procs.append(proc)
            return proc, f"127.0.0.1:{proc.port('broker listening on :')}"

        def cli_session(addr, size, turns):
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                code = controller_main(["-server", addr, "-w", str(size), "-h", str(size),
                                        "-turns", str(turns), "-noVis"])
            name = f"{size}x{size}x{turns}.pgm"
            check(code == 0, f"workers -server session {name} exit {code}")
            check((REPO / "out" / name).read_bytes()
                  == (REPO / "check" / "images" / name).read_bytes(),
                  f"workers -server session {name}: PGM bytes differ")
            ticks = re.findall(r"Completed Turns (\d+) Alive Cells (\d+)", printed.getvalue())
            for turn, count in ticks:
                turn, count = int(turn), int(count)
                want = first_ticks[size] if turn == 0 else golden_alive[size][turn]
                check(count == want, f"{name}: tick at turn {turn} says {count}, not {want}")
            return len(ticks)

        os.chdir(REPO)
        resident, addr = cli_broker("-wire", "resident", "-halo-depth", "8")
        t1 = time.monotonic()
        for size in (64, 512):
            for turns in (0, 1, 100):
                cli_session(addr, size, turns)
        sessions_wall = time.monotonic() - t1
        events20 = queue.Queue()
        remote = RemoteBroker(addr)
        try:
            res20t = run(Params(turns=100, image_width=512, image_height=512), events20,
                         broker=remote, images_dir=REPO / "images", out_dir=out_dir,
                         tick_seconds=0.02)
        finally:
            remote.close()
        ticks20 = []
        while not events20.empty():
            ev = events20.get_nowait()
            if isinstance(ev, AliveCellsCount):
                ticks20.append(ev)
        for ev in ticks20:
            want = first_ticks[512] if ev.completed_turns == 0 else \
                golden_counts[ev.completed_turns]
            check(ev.cells_count == want, f"512^2 tick at turn {ev.completed_turns}: "
                                          f"{ev.cells_count}, not {want}")
        check(res20t.turns_completed == 100, "the ticked 512^2 session")
        resident.stop()
        other_walls = {}
        for wire, flags in (("haloed", ("-wire", "haloed")),
                            ("grid 2x2", ("-wire", "resident", "-halo-depth", "8",
                                          "-grid", "2x2"))):
            proc, addr = cli_broker(*flags)
            t1 = time.monotonic()
            cli_session(addr, 512, 100)
            other_walls[wire] = time.monotonic() - t1
            if wire == "haloed":
                proc.stop()
        remote = RemoteBroker(addr)
        try:
            remote.super_quit()
        finally:
            remote.close()
        for proc in [*wprocs, procs[-1]]:
            check(proc.proc.wait(timeout=60) == 0, "a process SuperQuit should end failed")
    finally:
        for proc in procs:
            proc.stop()
    print(f"phase 20 workers CLI: four worker processes on the card (started in "
          f"{worker_start:.1f} s) and a workers broker (-wire resident -halo-depth 8, "
          f"GOL_WORKER_FUSED=on) serve -server sessions {{64,512}}^2 x {{0,1,100}} equal to "
          f"check/images byte for byte in {sessions_wall:.2f} s, a 512^2 x 100 session's "
          f"{len(ticks20)} ticks equal check/alive; 512^2 x 100 on -wire haloed "
          f"({other_walls['haloed']:.2f} s) and on -grid 2x2 ({other_walls['grid 2x2']:.2f} "
          f"s) golden; SuperQuit ended all five processes")

    # 20b. full size: a seeded 30%-alive 4096^2 soup x 1000 turns through
    # WorkersBackend over four in-process workers on the card (resident
    # wire, K = 8, GOL_WORKER_FUSED unset: auto routing, so each 1024 x 4096
    # strip is seeded on the card), against the port's DeviceBackend run
    # (its final board) and its engine one turn a chunk (every per-turn
    # count, kept out of the main path's counts). Every batch must reach W
    # (125 a worker), every strip must end on the card, and no StripStep
    # handler may pass over a strip-sized array on the host: the digests
    # and the dirty-tile grid come from W.
    side20, turns20, k20 = 4096, 1000, 8
    rows20 = side20 // 4
    soup20 = np.where(rng.random((side20, side20)) < 0.3, 255, 0).astype(np.uint8)
    ref20 = {}

    def record20(engine, state, turn):
        ref20[turn] = engine.retrieve(include_world=False).alive_count

    Engine(EngineConfig(max_chunk=1, chunk_hook=record20, device=dev)).run(
        Params(turns=turns20, image_width=side20, image_height=side20), soup20)
    dev_final = broker.DeviceBackend(dev).run(
        Request(world=soup20, turns=turns20, threads=4, image_width=side20,
                image_height=side20)).world
    in_handler = threading.local()
    host_passes = {"state_digest": 0, "dirty_tile_grid": 0}
    real = {"state_digest": integrity.state_digest, "dirty_tile_grid": sparse.dirty_tile_grid}

    def spy(name):
        def call(arr, *args, **kw):
            if getattr(in_handler, "on", False) and getattr(arr, "size", 0) >= rows20 * side20:
                host_passes[name] += 1
            return real[name](arr, *args, **kw)
        return call

    @contextlib.contextmanager
    def counted_run():
        integrity.state_digest = spy("state_digest")
        sparse.dirty_tile_grid = spy("dirty_tile_grid")
        open_window()
        try:
            yield
        finally:
            integrity.state_digest = real["state_digest"]
            sparse.dirty_tile_grid = real["dirty_tile_grid"]

    res20, wall20, batches20, service20, services20 = workers_run(
        rpc_worker, broker, dev, soup20, turns20, k20, around=counted_run, flag=in_handler)
    got = close_window("4096^2 through the workers backend", ("strip_steps",))
    n_batches = turns20 // k20
    check(got["strip_steps"] == 4 * n_batches and len(service20) == 4 * n_batches,
          f"{got['strip_steps']} strip kernel launches and {len(service20)} batches, not "
          f"{n_batches} a worker")
    check(res20.turns_completed == turns20 and np.array_equal(res20.world, dev_final),
          "4096^2 x 1000: the workers backend's board differs from DeviceBackend's")
    bad = [t0 + i + 1 for t0 in range(0, turns20, k20) for i in range(k20)
           if sum(batches20[(w, t0)][i] for w in range(4)) != ref20[t0 + i + 1]]
    check(not bad, f"4096^2 x 1000: per-turn counts differ from the engine's at {bad[:5]}")
    check(all(isinstance(svc._strip, torch.Tensor) and svc._strip.is_cuda
              for svc in services20), "4096^2 x 1000: a worker's strip is not on the card")
    check(host_passes == {"state_digest": 0, "dirty_tile_grid": 0},
          f"4096^2 x 1000: strip-sized host passes inside the handlers: {host_passes}")
    sessions20 = [svc._resident for svc in services20]
    up_b = sum(x.bytes_up for x in sessions20) / (4 * n_batches)
    down_b = sum(x.bytes_down for x in sessions20) / (4 * n_batches)
    fetched_b = sum(x.bytes_fetched for x in sessions20)

    # a batch of 20b's shape taken apart (worker 0's strip and halos): W's
    # device time beside its bound, the one copy up (halos and the zeroes
    # W's sums, counts and grid start from), the one copy down (edges,
    # counts, grid, sums, bands) with the batch's one synchronisation, the
    # host's digest folds (edges, bands, and the two strip digests from
    # W's sums), the session's whole batch, and the handler of one worker
    # alone
    strip_np = soup20[:rows20].copy()
    halos = np.concatenate([soup20[-k20:], soup20[rows20:rows20 + k20]])
    strip_dev = torch.from_numpy(strip_np).to(dev)
    batch_io = rpc_worker._BatchIO(rows20, side20, k20, True, dev)
    np.copyto(batch_io.up[:batch_io.halo_bytes].numpy().reshape(2 * k20, side20), halos)
    into = batch_io.into._replace(strip=torch.empty_like(strip_dev))

    def batch20():
        return strip_steps.strip_batch(batch_io.halos[:k20], strip_dev, batch_io.halos[k20:],
                                       k20, True, into=into)

    def host_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    up_ms = host_ms(lambda: batch_io.dev[:batch_io.zero_end].copy_(batch_io.up,
                                                                   non_blocking=True))
    w_dev_ms, _ = device_ms(batch20, "strip_steps_kernel", reps=20)
    w_bytes = (rows20 + 2 * k20) * side20 + rows20 * side20 + 2 * side20 * k20 * (k20 - 1) \
        + 4 * k20 + 16 * 16 + 32 + 2 * k20 * side20
    w_ops = (rows20 + 2 * k20) * side20 * bitpack.byte_ops_per_cell(
        CONWAY.birth_mask, CONWAY.survive_mask, k20)

    def down():
        batch_io.down.copy_(batch_io.dev[batch_io.down_from:], non_blocking=True)
        torch.cuda.current_stream().synchronize()

    down_ms = host_ms(down)
    out = batch_io.host
    edges_np, sums_np, bands_np = out.edges.numpy(), out.sums.tolist(), out.bands.numpy()

    def folds():
        integrity.state_add_sums(integrity.state_new(), (rows20, side20), np.uint8, *sums_np[:2])
        integrity.state_add_sums(integrity.state_new(), (rows20, side20), np.uint8, *sums_np[2:])
        integrity.state_digest(edges_np)
        at = ab = integrity.state_new()
        for top, bottom in strip_steps.split_bands(bands_np, k20, side20):
            at, ab = integrity.state_add(at, top), integrity.state_add(ab, bottom)

    fold_ms = host_ms(folds, reps=20)
    session = rpc_worker._ResidentStrip(strip_np, dev)
    with session.on_stream():
        step_ms = host_ms(lambda: session.step(halos, k20, True), reps=20)
    # the same batch through one worker alone (no other worker's handler
    # or the broker's threads in this process): the handler's own cost
    solo_server, solo = rpc_worker.serve(0, device=dev)
    try:
        solo.strip_start(Request(world=strip_np, worker=0))
        check(solo._resident is not None, "the solo worker's strip is on the card")
        solo_ms = []
        for i in range(12):
            t = time.perf_counter()
            solo.strip_step(Request(world=halos, worker=0, turns=k20, initial_turn=k20 * i))
            solo_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        solo_server.stop()
    solo_ms = min(solo_ms[1:])
    svc_ms = 1e3 * sum(service20) / len(service20)
    print(f"phase 20b workers at full size: 4096^2 30% soup x 1000 turns through "
          f"WorkersBackend over 4 in-process workers on the card (resident wire, K = 8, "
          f"auto routing): board equals DeviceBackend's, every per-turn count equals the "
          f"engine's, {got['strip_steps']} strip kernel launches = {n_batches} batches a "
          f"worker, the four strips on the card at the end, strip-sized host passes in the "
          f"handlers {sum(host_passes.values())}; wall {wall20:.3f} s "
          f"({turns20 / wall20:.1f} turns/s); a worker's StripStep handler {svc_ms:.3f} ms a "
          f"batch on average; bytes across PCIe a batch: {up_b:.0f} up, {down_b:.0f} down "
          f"(and {fetched_b} fetched at syncs in all); timed apart: W {w_dev_ms:.4f} ms of "
          f"device time (bound {max(w_bytes / HBM_BYTES_PER_S, w_ops / int32_rate) * 1e3:.5f} "
          f"ms), the copy up {up_ms:.3f} ms, the copy down with the batch's "
          f"synchronisation {down_ms:.3f} ms, the host's digest folds {fold_ms:.3f} ms, the "
          f"session's whole batch {step_ms:.3f} ms; one worker alone takes {solo_ms:.3f} ms "
          f"a batch {card_tag}")
    del strip_dev, batch_io, into, out, session


    for name in counted:
        check(launches[name] > 0, f"{name} kernel never launched on the main path")
        check(plain[name] == 0, f"{name} plain version ran {plain[name]} times on the card")

    # -- 8. kernel timings ------------------------------------------------
    opw = bitpack.ops_per_word(CONWAY.birth_mask, CONWAY.survive_mask)
    print(f"bound: {opw} int32 instructions per word per turn (Conway, "
          "ops/bitpack.py::ops_per_word)")

    def bound(words, turns, extra_bytes=0):
        t_bytes = (2 * 4 * words + extra_bytes) / HBM_BYTES_PER_S
        t_ops = turns * words * opw / int32_rate
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")

    p512 = bitpack.pack(board512, 0, dev)
    k1_n = 100
    k1_ms = cuda_ms(lambda: whole_board.step_n(p512, k1_n, counted=True), reps=50)
    k1_plain_ms = cuda_ms(lambda: whole_board.step_n_plain(p512, k1_n), reps=3, warmup=1)
    k1_bound_ms, k1_by = bound(p512.numel(), k1_n, 4 * p512.shape[0])
    k1_long_ms = cuda_ms(lambda: whole_board.step_n(p512, 1000, counted=True), reps=5)
    print(f"timing whole-board 512^2: {k1_long_ms * 1e3 / 1000:.3f} us/turn "
          f"(n=1000 per launch); {k1_ms:.4f} ms per n={k1_n} launch, bound "
          f"{k1_bound_ms:.5f} ms ({k1_by}), {k1_ms / k1_bound_ms:.3g}x the bound; plain "
          f"{k1_plain_ms:.3f} ms {card_tag}")

    tiled_times = {}
    for shape in ((128, 4096), (512, 16384)):
        packed = random_words(shape)
        per_turn = cuda_ms(lambda: tiled.step_n(packed, 64), reps=5) / 64
        one_launch = cuda_ms(lambda: tiled.step_n(packed, tiled.MAX_TURNS), reps=10)
        plain_ms = cuda_ms(lambda: tiled.step_n_plain(packed, tiled.MAX_TURNS),
                           reps=2, warmup=1)
        b_ms, b_by = bound(packed.numel(), tiled.MAX_TURNS)
        tiled_times[shape] = (one_launch, plain_ms, b_ms, b_by)
        side = int((packed.numel() * 32) ** 0.5)
        device, _ = device_ms(lambda: tiled.step_n(packed, tiled.MAX_TURNS),
                              "tiled_kernel", reps=10)
        print(f"timing tiled {side}^2: {per_turn * 1e3:.3f} us/turn (n=64, 8 "
              f"launches); {one_launch:.4f} ms per 8-turn launch ({device:.4f} ms of "
              f"device time), bound {b_ms:.5f} ms ({b_by}), {one_launch / b_ms:.3g}x the "
              f"bound; plain {plain_ms:.3f} ms {card_tag}")

    # the tiled kernel at 65536^2, the largest board an entry point gives it
    t65_ms = cuda_ms(lambda: tiled.step_n(state65, tiled.MAX_TURNS), reps=10)
    t65_dev, t65_traced = device_ms(lambda: tiled.step_n(state65, tiled.MAX_TURNS),
                                    "tiled_kernel", reps=10)
    t65_bound, t65_by = bound(state65.numel(), tiled.MAX_TURNS)
    print(f"timing tiled 65536^2: {t65_dev:.4f} ms of device time per 8-turn launch "
          f"({t65_traced} traced; events {t65_ms:.4f} ms per call), bound {t65_bound:.5f} ms "
          f"({t65_by}), {t65_dev / t65_bound:.3g}x the bound; {launches65} launches for 1000 "
          f"turns, {launches65 * t65_dev / 1e3:.4f} s of device time {card_tag}")
    del state65

    # the activity-sparse kernel: one 8-turn block (a list pass at the
    # dispatch's start, then a step, a scatter and a dilate launch a block)
    # on the R-pentomino after 1000 turns at 16384^2 and 65536^2, events per
    # block over a dispatch of 64 (the board's copy included) and the
    # profiler's device time of the four kernels; the bound counts the
    # active tiles' words at ops_per_word x 8 against the windows read, the
    # tiles written and the grid read and written
    sparse_kernels = "sparse_(?:list|step|scatter|dilate)_kernel"

    def sparse_bound(tile, h_turns, tiles_per_block, grid_tiles):
        tr, tc = tile
        t_ops = tiles_per_block * tr * tc * opw * h_turns / int32_rate
        t_bytes = (tiles_per_block * ((tr + 2) * (tc + 2 * h_turns) + tr * tc) * 4
                   + 2 * grid_tiles) / HBM_BYTES_PER_S
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")

    def sparse_block_times(st, blocks=64):
        tile = sparse.sparse_tile_shape(tuple(st.packed.shape))
        total = (st.packed.shape[0] // tile[0]) * (st.packed.shape[1] // tile[1])
        cap = min(sparse._pow2_ceil(max(st.count, 8) * 4), sparse._pow2_ceil(total))

        def call():
            return sparse_tiles.dispatch(st.packed, st.grid, blocks, tile, 8, cap, 8, 12)

        run_ = call()
        check(run_.blocks_done == blocks, f"the timed dispatch stopped at {run_.blocks_done}")
        events_ms = cuda_ms(call, reps=5, warmup=1) / blocks
        per_launch, traced = device_ms(call, sparse_kernels, reps=3, per_call=1 + 3 * blocks)
        device = per_launch * (1 + 3 * blocks) / blocks
        b_ms, b_by = sparse_bound(tile, 8, run_.active_sum / blocks, total)
        return events_ms, device, b_ms, b_by, run_.active_sum / blocks, traced, tile, cap

    sparse_times = {}
    for label, st in (("16384^2", sparse16), ("65536^2", sparse65)):
        ev, dv, b_ms, b_by, per_block, traced, tile, cap = sparse_block_times(st)
        sparse_times[label] = (ev, dv, b_ms, b_by, tile, cap)
        print(f"timing sparse {label} R-pentomino after 1000 turns: {dv:.4f} ms of device time "
              f"per 8-turn block ({traced} launches traced; events {ev:.4f} ms per block over a "
              f"dispatch of 64, the board's copy included), {per_block:.1f} active tiles of "
              f"{tile[0]} x {tile[1]} words a block, bound {b_ms:.6f} ms ({b_by}), "
              f"{dv / b_ms:.3g}x the bound {card_tag}")
    ev16, dv16, b16, by16, tile16, cap16 = sparse_times["16384^2"]
    sparse_plain_ms = cuda_ms(lambda: sparse_tiles.dispatch_plain(
        sparse16.packed, sparse16.grid, 8, tile16, 8, cap16, 8, 12), reps=1, warmup=1) / 8
    print(f"timing sparse plain program on the card at 16384^2 (torch ops, a measurement: "
          f"it is not on the path): {sparse_plain_ms:.3f} ms per 8-turn block {card_tag}")

    def device_total_ms(fn) -> float:
        """All kernels' device time in a trace of one ``fn()``, the fullest
        of three traces (a trace may lose records, see ``trace``)."""
        fn()
        return max(sum(us for _, us in window_kernels(trace(fn), r".")) for _ in range(3)) / 1e3

    def timed_wall(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return time.monotonic() - t0, out

    # what a dispatch pays beside its blocks at 65536^2: the copy of the
    # board it writes into (its input is never written), and the period-2
    # probe's two one-turn dispatches and two whole-board comparisons, over
    # the wall of the 65536^2 R-pentomino x 1000 on the sparse plane
    real_dispatch, dispatched = sparse_tiles.dispatch, []

    def counting_dispatch(*args):
        dispatched.append(args[4])  # h: the probe's dispatches are h = 1
        return real_dispatch(*args)

    seed65 = bigboard.seed_packed(size65, bigboard.r_pentomino(size65))
    sparse_tiles.dispatch = counting_dispatch
    try:
        wall65, _ = timed_wall(lambda: plane65.step_n(plane65.from_packed(seed65), 1000))
    finally:
        sparse_tiles.dispatch = real_dispatch
    copy65 = cuda_ms(lambda: sparse65.packed.clone(), reps=10)
    twin65 = sparse65.packed.clone()
    equal65 = cuda_ms(lambda: torch.equal(sparse65.packed, twin65), reps=10)
    # a probe is two one-turn dispatches and at most two comparisons
    one_turn65 = dispatched.count(1)
    overhead65 = len(dispatched) * copy65 + one_turn65 * equal65
    print(f"timing sparse 65536^2 R-pentomino x 1000 on the plane: wall {wall65 * 1e3:.3f} ms, "
          f"{len(dispatched)} dispatches ({one_turn65} of one turn: the period-2 probe's and "
          f"any tail); a dispatch's board copy {copy65:.4f} ms, a whole-board comparison "
          f"{equal65:.4f} ms: copies {len(dispatched) * copy65:.3f} ms and at most "
          f"{one_turn65 * equal65:.3f} ms of the probe's comparisons, "
          f"{100 * overhead65 / (wall65 * 1e3):.1f}% of the wall {card_tag}")
    del seed65, twin65

    # sparse against dense: the R-pentomino x 1000 through each plane (wall
    # with a synchronise, and device time) from 1024^2 to 65536^2, which is
    # where SPARSE_MIN_CELLS stands; then one 8-turn block of the sparse
    # kernel against one 8-turn launch of the tiled kernel on soups with 5%,
    # 25%, 50% and 100% of the tiles active (capacity for every tile, so no
    # overflow), which is where the density crossover stands, and the two
    # planes' walls for 64 turns of the 5% and 25% soups
    print("sparse against dense, the R-pentomino x 1000 (wall s / device ms; sparse "
          "from_packed included):")
    for side in (1024, 2048, 4096, 8192, 16384, 65536):
        seed_words = bigboard.seed_packed(side, bigboard.r_pentomino(side))
        sp, bp = SparseBitPlane(CONWAY, device=dev), BitPlane(CONWAY, 0, dev)
        s_wall, s_out = timed_wall(lambda: sp.step_n(sp.from_packed(seed_words), 1000))
        d_wall, d_out = timed_wall(lambda: bp.step_n(seed_words, 1000))
        check(torch.equal(s_out.packed, d_out), f"{side}^2 sparse and dense boards differ")
        s_dev = device_total_ms(lambda: sp.step_n(sp.from_packed(seed_words), 1000))
        d_dev = device_total_ms(lambda: bp.step_n(seed_words, 1000))
        print(f"  {side}^2: sparse {s_wall:.4f} s / {s_dev:.3f} ms, dense {d_wall:.4f} s / "
              f"{d_dev:.3f} ms ({d_wall / s_wall:.3g}x by wall) {card_tag}")
        del seed_words, s_out, d_out
    print("sparse against dense, one 8-turn block of the sparse kernel against one 8-turn "
          "tiled launch (device ms / events ms), and 64 turns through each plane (wall s):")
    for side in (4096, 16384, 65536):
        shape = bitpack.packed_shape(side, side)
        tile = sparse.sparse_tile_shape(shape)
        total = (shape[0] // tile[0]) * (shape[1] // tile[1])
        for frac in (0.05, 0.25, 0.5, 1.0):
            packed = tile_soup(shape, tile, frac, seed=side + int(frac * 1000))
            grid = sparse.occupancy_grid(packed, *tile)
            count = int(grid.sum())
            cap = sparse._pow2_ceil(total)

            def one_block():
                return sparse_tiles.dispatch(packed, grid, 1, tile, 8, cap, 8, 12)

            s_dev = device_ms(one_block, sparse_kernels, reps=5, per_call=4)[0] * 4
            s_ev = cuda_ms(one_block, reps=5)
            d_dev = device_ms(lambda: tiled.step_n(packed, 8), "tiled_kernel", reps=5)[0]
            d_ev = cuda_ms(lambda: tiled.step_n(packed, 8), reps=5)
            row = (f"  {side}^2, {count}/{total} tiles active ({count / total:.3f}): sparse "
                   f"{s_dev:.4f} / {s_ev:.4f} ms, dense {d_dev:.4f} / {d_ev:.4f} ms, "
                   f"sparse/dense {s_dev / d_dev:.3g} (device)")
            if frac in (0.05, 0.25):
                sp, bp = SparseBitPlane(CONWAY, device=dev), BitPlane(CONWAY, 0, dev)
                s_wall, s_out = timed_wall(lambda: sp.step_n(sp.from_packed(packed), 64))
                d_wall, d_out = timed_wall(lambda: bp.step_n(packed, 64))
                check(torch.equal(s_out.packed, d_out), f"{side}^2 soup: planes differ")
                row += (f"; 64 turns: sparse plane {s_wall:.4f} s (ends with {s_out.count} "
                        f"active), dense {d_wall:.4f} s")
                del s_out, d_out
            print(row + f" {card_tag}")
            del packed, grid

    k2_out = []
    k2_ms = cuda_ms(lambda: k2_out.append(batch_board.step_n(p8, turns8)), reps=20)
    k2_plain_ms = cuda_ms(lambda: batch_board.step_n_plain(p8, turns8), reps=3, warmup=1)
    err = max(max(max_abs_err(got, plain8), max_abs_err(got_counts, plain8_counts))
              for got, got_counts in k2_out)
    check(err == 0, f"timed batched launches at 1000 x 128^2: max abs err {err}")
    k2_err = max(k2_err, err)
    del k2_out
    k2_bound_ms, k2_by = bound(p8.numel(), turns8, 4 * p8.shape[0] * p8.shape[1])
    print(f"timing batched 1000 x 128^2: {k2_ms:.4f} ms per counted n={turns8} launch "
          f"({k2_ms * 1e3 / turns8:.3f} us/turn for the batch), bound {k2_bound_ms:.5f} "
          f"ms ({k2_by}), {k2_ms / k2_bound_ms:.3g}x the bound; plain {k2_plain_ms:.3f} "
          f"ms {card_tag}")

    # K2 at the shape the broker's 256 SessionRuns give it (phase 10): a
    # power-of-two chunk of 64 turns over 256 boards of 128^2, device time
    p10 = bitpack.pack_batch(boards, 0, dev)
    got10 = batch_board.step_n(p10, 64)
    want10 = batch_board.step_n_plain(p10, 64)
    err = max(max_abs_err(got10[0], want10[0]), max_abs_err(got10[1], want10[1]))
    check(err == 0, f"batched 256 x 128^2, n=64: max abs err {err}")
    k2_10_ms, k2_10_traced = device_ms(lambda: batch_board.step_n(p10, 64),
                                       "whole_board_kernel", reps=20)
    k2_10_events = cuda_ms(lambda: batch_board.step_n(p10, 64), reps=50)
    k2_10_bound, k2_10_by = bound(p10.numel(), 64, 4 * p10.shape[0] * p10.shape[1])
    print(f"timing batched 256 x 128^2 (phase 10's shape): {k2_10_ms:.4f} ms of device "
          f"time per counted n=64 launch ({k2_10_traced} traced; events {k2_10_events:.4f} "
          f"ms per call), bound {k2_10_bound:.5f} ms ({k2_10_by}), "
          f"{k2_10_ms / k2_10_bound:.3g}x the bound {card_tag}")

    print(f"bound: the byte board in its cheapest form, packed once, {opw}/32 int32 "
          f"instructions per cell per turn, unpacked once ({2 * bitpack.PACK_OPS_PER_CELL} "
          "per cell; Conway, ops/bitpack.py::byte_ops_per_cell)")

    def byte_bound(cells, turns):
        t_bytes = 2 * cells / HBM_BYTES_PER_S
        ops_cell = bitpack.byte_ops_per_cell(CONWAY.birth_mask, CONWAY.survive_mask, turns)
        t_ops = cells * ops_cell / int32_rate
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")

    # the byte kernels' ms is their device time from the profiler: at the
    # shapes the step functions give them a launch can be shorter than its
    # wrapper's host work, which CUDA events around back-to-back calls time
    K5 = "byte_board_(?:bits|bytes)_kernel"
    K6 = "byte_tiled_kernel"

    def byte_times(fn, kernel, reps):
        """``(device ms per call, launches per call, events ms per call)``:
        the mean device time of a launch times the launches one call
        counts."""
        before = byte_board.launches + byte_tiled.launches
        fn()
        per_call = byte_board.launches + byte_tiled.launches - before
        per_launch, _ = device_ms(fn, kernel, reps=reps, per_call=per_call)
        return per_launch * per_call, per_call, cuda_ms(fn, reps=reps)

    # K5 at the main path's shapes (16^2, 64^2, the gate's square) and, with
    # the form forced past the gate, at 256^2 and 512^2
    k5_rows = {}
    for size, n, reps in ((64, 8, 50), (64, 100, 20), (16, 8, 50), (gate_side, 8, 50),
                          (gate_side, 100, 20), (256, 100, 20), (512, 8, 50), (512, 100, 20)):
        board = random_bytes((size, size))
        form, cluster = byte_board.form((size, size)), byte_board.cluster_size((size, size))

        def launch():
            byte_board.step_n(board, n, form=form)

        got = byte_board.step_n(board, n, form=form)
        check(torch.equal(got, byte_board.step_n_plain(board, n)), f"timed K5 {size}^2 n={n}")
        dev_ms, _, ev_ms = byte_times(launch, K5, reps)
        b_ms, b_by = byte_bound(board.numel(), n)
        k5_rows[size, n] = (dev_ms, b_ms, b_by)
        print(f"timing whole-board byte {size}^2 ({form}, cluster of {cluster}): "
              f"{dev_ms:.4f} ms of device time per n={n} launch "
              f"({dev_ms * 1e3 / n:.3f} us/turn; events {ev_ms:.4f} ms per call), bound "
              f"{b_ms:.6f} ms ({b_by}), {dev_ms / b_ms:.3g}x the bound {card_tag}")
    b64 = random_bytes((64, 64))
    k5_ms, k5_bound_ms, k5_by = k5_rows[64, 100]
    k5_plain_ms = cuda_ms(lambda: byte_board.step_n_plain(b64, 100), reps=3, warmup=1)
    print(f"timing whole-board byte 64^2: plain {k5_plain_ms:.3f} ms per n=100 {card_tag}")

    k6_times = {}
    for shape, k in (((512, 512), 8), ((4096, 4096), 8), ((4096, 4096), 32)):
        board = random_bytes(shape)

        def launch_k():
            byte_tiled.step_n(board, k, turns_per_launch=k)

        one_launch, _, events_ms = byte_times(launch_k, K6, 20)
        plain_ms = cuda_ms(lambda: byte_tiled.step_n_plain(board, k, turns_per_launch=k),
                           reps=2, warmup=1)
        b_ms, b_by = byte_bound(board.numel(), k)
        k6_times[shape, k] = (one_launch, plain_ms, b_ms, b_by)
        print(f"timing byte tiles {shape[0]}x{shape[1]} (tile "
              f"{byte_tiled.tile_for(shape)}): {one_launch:.4f} ms of device "
              f"time per {k}-turn launch ({one_launch * 1e3 / k:.3f} "
              f"us/turn; events {events_ms:.4f} ms per call), bound {b_ms:.5f} ms ({b_by}), "
              f"{one_launch / b_ms:.3g}x the bound; plain {plain_ms:.3f} ms {card_tag}")

    # the crossover that sets K5's gate: n turns in one K5 launch (its own
    # pick of form and cluster, whatever the gate says) against the same
    # turns on the byte tiles at 8 and at 32 turns a launch; per call, device
    # time summed over the call's launches and CUDA events around the calls.
    # 16^2 and 100^2 take K5's byte form, the others its bit form.
    print(f"crossover K5 against K6, ms per call as device/events {card_tag}:")
    for size in (16, 100, 64, 128, 160, 192, 224, 256, 512, 1024, 2048):
        shape = (size, size)
        board = random_bytes(shape)
        form = byte_board.form(shape)
        on_chip = byte_board.smem_bytes(shape) <= smem_limit
        for n in (8, 32, 100):
            cells = []
            if on_chip:
                d, _, e = byte_times(lambda: byte_board.step_n(board, n, form=form), K5, 10)
                cells.append(f"K5 ({form}, cluster of {byte_board.cluster_size(shape)}) "
                             f"{d:.4f}/{e:.4f}")
            else:
                cells.append("K5 does not fit")
            for k in (8, 32):
                d, per_call, e = byte_times(
                    lambda: byte_tiled.step_n(board, n, turns_per_launch=k), K6, 10)
                cells.append(f"K6 at {k} a launch ({per_call:.0f} launches) {d:.4f}/{e:.4f}")
            gate = "under" if byte_board.fits(shape, dev) else "past"
            print(f"  {size}^2 ({gate} the gate) n={n}: " + "; ".join(cells))


    # the strip kernel at 20b's batch: one 8-turn launch on a 4096-wide
    # strip of 1024 rows with its bands, dirty grid and digest sums, device
    # time; its plain version (torch ops on the card, not on the path) by
    # events. The bound's bytes: the block read once; the strip, bands,
    # counts, the 16 x 16 grid, four sums and the 2K edge rows written once
    strip_block = random_bytes((1024 + 16, 4096))
    w_ms, _ = device_ms(lambda: strip_steps.strip_steps(strip_block, 8, 1024, attest=True),
                        "strip_steps_kernel", reps=20)
    w_plain_ms = cuda_ms(lambda: strip_steps.strip_steps_plain(strip_block, 8, 1024, True),
                         reps=3, warmup=1)
    w_bytes = (strip_block.numel() + 1024 * 4096 + 2 * 4096 * 8 * 7 + 4 * 8 + 16 * 16 + 32
               + 2 * 8 * 4096)
    w_t_bytes = w_bytes / HBM_BYTES_PER_S
    w_t_ops = strip_block.numel() * bitpack.byte_ops_per_cell(
        CONWAY.birth_mask, CONWAY.survive_mask, 8) / int32_rate
    w_bound_ms = max(w_t_bytes, w_t_ops) * 1e3
    w_by = "bytes" if w_t_bytes > w_t_ops else "operations"
    print(f"timing strip kernel 1040x4096, 8 turns with bands: {w_ms:.4f} ms of device "
          f"time per launch, bound {w_bound_ms:.5f} ms ({w_by}: {w_bytes} bytes), "
          f"{w_ms / w_bound_ms:.3g}x the bound; plain {w_plain_ms:.3f} ms {card_tag}")
    del strip_block

    # the workers' fused gate: the whole strip batch as a worker runs it
    # (bands and their digests on), through W with its copies against the
    # numpy dense loop (the numpy function's two modes), and the whole
    # StripStep handler on a worker whose strip is resident on the card
    # against one that keeps a numpy strip (GOL_WORKER_FUSED=off: dense,
    # its digests and its dirty-tile grid on the host), host wall in ms
    # (best of 3, of 1 past 2^20 cells), for strips of 2^10 to 2^24 cells
    # of 20b's soup at K = 1 and 8. FUSED_STRIP_MIN_CELLS follows the rule
    # PERF.md fixed beforehand, the smallest size from which W wins at K = 8
    # at it and every larger size, read on the handlers' pair: the gate
    # decides where a session's strip lives
    print(f"fused gate: a strip batch through W (copies included) / the numpy dense "
          f"loop, then a StripStep on a resident session / on a numpy session, ms "
          f"{card_tag}:")
    wins, wins_res = {}, {}
    for exp in range(10, 25, 2):
        cells = 1 << exp
        width = min(4096, cells // 8)
        h = cells // width
        row = []
        for k in (1, 8):
            strip = soup20[:h, :width].copy()
            top = soup20[-k:, :width].copy()
            bottom = soup20[np.arange(h, h + k) % side20, :width]
            reps = 3 if cells <= 1 << 20 else 1
            walls = {}
            for mode, device in (("fused", dev), ("dense", None)):
                best = 1e9
                for _ in range(reps + 1):  # the first call warms up
                    t = time.perf_counter()
                    out = rpc_worker.strip_step_batch(strip, top, bottom, k, True, mode=mode,
                                                      device=device)
                    best = min(best, time.perf_counter() - t)
                walls[mode] = (best * 1e3, out)
            check(np.array_equal(walls["fused"][1][0], walls["dense"][1][0])
                  and walls["fused"][1][1:] == walls["dense"][1][1:],
                  f"fused and dense strip batches differ at {h}x{width}, k={k}")
            halos = np.concatenate([top, bottom])
            replies = {}
            for name, env in (("resident", "auto"), ("numpy", "off")):
                os.environ["GOL_WORKER_FUSED"] = env
                svc = rpc_worker.WorkerService(None, dev)
                svc.strip_start(Request(world=strip, worker=0))
                check((svc._resident is not None) == (name == "resident"),
                      f"a {h}x{width} {name} session")
                best = 1e9
                for i in range(reps + 1):  # the first call warms up
                    t = time.perf_counter()
                    reply = svc.strip_step(Request(world=halos, worker=0, turns=k,
                                                   initial_turn=k * i))
                    best = min(best, time.perf_counter() - t)
                    replies.setdefault(name, reply)
                walls[name] = (best * 1e3, None)
                del svc
            os.environ.pop("GOL_WORKER_FUSED")
            a, b = replies["resident"], replies["numpy"]
            check(a.counts == b.counts == walls["dense"][1][1] and a.digests == b.digests
                  and np.array_equal(a.edges, b.edges) and np.array_equal(a.dirty, b.dirty),
                  f"resident and numpy sessions' replies differ at {h}x{width}, k={k}")
            wins[exp, k] = walls["fused"][0] <= walls["dense"][0]
            wins_res[exp, k] = walls["resident"][0] <= walls["numpy"][0]
            ms = {name: wall for name, (wall, _) in walls.items()}
            row.append(f"k={k}: {ms['fused']:.3f} / {ms['dense']:.3f} "
                       f"({ms['dense'] / ms['fused']:.3g}x), {ms['resident']:.3f} / "
                       f"{ms['numpy']:.3f} ({ms['numpy'] / ms['resident']:.3g}x)")
        print(f"  2^{exp} cells ({h}x{width}): " + "; ".join(row))
    exps = sorted({e for e, _ in wins})

    def rule(won, k):
        e = next((e for e in exps if all(won[x, k] for x in exps if x >= e)), None)
        return "none measured" if e is None else f"2^{e} cells"

    print(f"fused gate by the rule on the sessions' handlers: {rule(wins_res, 8)}, on the "
          f"numpy function's modes {rule(wins, 8)} (rpc/worker.py::FUSED_STRIP_MIN_CELLS = "
          f"{rpc_worker.FUSED_STRIP_MIN_CELLS}); K = 1 wins from {rule(wins_res, 1)} on the "
          f"handlers, {rule(wins, 1)} on the modes")

    # -- 7. the kernels line ----------------------------------------------
    big_shape = (512, 16384)
    kernels = [
        {
            "name": "whole_board",
            "route": "cuda",
            "source": "gol_distributed_final_tpu_torch/csrc/whole_board.cu",
            "replaces": "gol_distributed_final_tpu/ops/pallas_stencil.py:217",
            "launches": launches["whole_board"],
            "max_abs_err": k1_err,
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound_ms,
            "bound_by": k1_by,
            "library_ms": None,
        },
        {
            "name": "tiled",
            "route": "cuda",
            "source": "gol_distributed_final_tpu_torch/csrc/tiled.cu",
            "replaces": "gol_distributed_final_tpu/ops/pallas_tiled.py:284",
            "launches": launches["tiled"],
            "max_abs_err": tiled_err,
            "ms": tiled_times[big_shape][0],
            "plain_ms": tiled_times[big_shape][1],
            "bound_ms": tiled_times[big_shape][2],
            "bound_by": tiled_times[big_shape][3],
            "library_ms": None,
        },
        {
            "name": "batch_board",
            "route": "cuda",
            "source": "gol_distributed_final_tpu_torch/csrc/whole_board.cu",
            "replaces": "gol_distributed_final_tpu/ops/pallas_stencil.py:298",
            "launches": launches["batch_board"],
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound_ms,
            "bound_by": k2_by,
            "library_ms": None,
        },
        {
            "name": "byte_board",
            "route": "cuda",
            "source": "gol_distributed_final_tpu_torch/csrc/byte_board.cu",
            "replaces": "gol_distributed_final_tpu/ops/pallas_stencil.py:125",
            "launches": launches["byte_board"],
            "max_abs_err": k5_err,
            "ms": k5_ms,
            "plain_ms": k5_plain_ms,
            "bound_ms": k5_bound_ms,
            "bound_by": k5_by,
            "library_ms": None,
        },
        {
            "name": "byte_tiled",
            "route": "cuda",
            "source": "gol_distributed_final_tpu_torch/csrc/byte_tiled.cu",
            "replaces": "gol_distributed_final_tpu/ops/fused.py:342",
            "launches": launches["byte_tiled"],
            "max_abs_err": k6_err,
            "ms": k6_times[(512, 512), 8][0],
            "plain_ms": k6_times[(512, 512), 8][1],
            "bound_ms": k6_times[(512, 512), 8][2],
            "bound_by": k6_times[(512, 512), 8][3],
            "library_ms": None,
        },
        {
            "name": "sparse_tiles",
            "route": "cuda",
            "source": "gol_distributed_final_tpu_torch/csrc/sparse_tiles.cu",
            "replaces": "gol_distributed_final_tpu/ops/sparse.py:189",
            "launches": launches["sparse_tiles"],
            "max_abs_err": sp_err,
            "ms": dv16,
            "plain_ms": sparse_plain_ms,
            "bound_ms": b16,
            "bound_by": by16,
            "library_ms": None,
        },
        {
            "name": "strip_steps",
            "route": "cuda",
            "source": "gol_distributed_final_tpu_torch/csrc/strip_steps.cu",
            "replaces": "gol_distributed_final_tpu/ops/fused.py:673",
            "launches": launches["strip_steps"],
            "max_abs_err": w_err,
            "ms": w_ms,
            "plain_ms": w_plain_ms,
            "bound_ms": w_bound_ms,
            "bound_by": w_by,
            "library_ms": None,
        },
    ]
    print("kernels: " + "; ".join(
        f"{k['name']} (replaces {k['replaces']}) launches={k['launches']} "
        f"plain_on_card={plain[k['name']]} parity={'exact' if k['max_abs_err'] == 0 else 'FAIL'}"
        for k in kernels
    ))
    print("units: whole_board ms = one counted launch of 100 turns at 512^2; "
          "tiled ms = one 8-turn launch at 16384^2; batch_board ms = one counted "
          "launch of 100 turns over 1000 x 128^2 (CUDA events); byte_board ms = one "
          "launch of 100 turns at 64^2; byte_tiled ms = one 8-turn launch at 512^2; "
          "sparse_tiles ms = one 8-turn block (step, scatter, dilate, and a 64th of the "
          "dispatch's list pass) on the 16384^2 R-pentomino after 1000 turns, its plain_ms "
          "the plain program's block on the card "
          "(the profiler's device time); strip_steps ms = one 8-turn launch on a 1040x4096 "
          "block with its bands, dirty grid and digest sums (20b's batch, device time); "
          "library_ms "
          "null: no single PyTorch call computes a life-like turn")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kernel-times"]:
        sys.exit(kernel_times(sys.argv[2] if len(sys.argv) > 2 else str(REPO)))
    if sys.argv[1:2] == ["--workers-times"]:
        sys.exit(workers_times(sys.argv[2] if len(sys.argv) > 2 else str(REPO)))
    sys.exit(main())
