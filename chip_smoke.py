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
``DeviceBackend``), drives the multi-device planes on one card (a (2, 4)
mesh of eight shards on cuda:0: the 16384^2 R-pentomino through
``Engine.run`` on ``ShardedBitPlane`` at halo depths 1 and 8, each block
on the tiled kernel, held against the single-board run; a 4096^2 soup at
depths 1, 3 and 8; the byte mesh plane's 512^2 sessions) and the pod (its
CLI in a child process that joined a one-rank NCCL group, the 16384^2
R-pentomino, stopped at turn 500 and resumed), drives the observability
layer on the card (phase 23: the 512^2 x 10000 session through ``run()``
and ``fused_step_n`` with ``-metrics -report -trace -timeline -profile``,
equal to the run without them and to check/alive, each kernel site's
CUDA-event count equal to its wrapper's launch counter, its device time a
launch against the kernel's own, its rates under the card's ceilings; a
broker with every server flag serving a ``-server`` session and 256
SessionRuns, its Status read by ``obs.status`` with the roofline classes;
``-trace-device``; and the flags' host cost), drives the operator tools
against the port's roles on the card (phase 24, ``--tools`` below), drives
the per-turn alive history (phase 25, ``--alive`` below) and a session
soak (phase 26, ``--soak`` below), each counted in a window of its own
out of the main path's counts, and
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
trees can be compared in turns within one call on one card. The sparse
kernel is timed by its device span a block (the first sparse kernel's
start to the last one's end in a 64-block dispatch), whatever launches
the tree's design makes.

    python3 chip_smoke.py --sparse-sweep [DIR]

builds edited copies of this checkout's sparse kernel under DIR (default
build/sweep), the tile whole or in parts, 224 or 480 threads, grids of
48 to 264 CTAs, an OR barrier every turn, and prints for each one JSON
line of its time a block by CUDA events around its launch.

    python3 chip_smoke.py --sparse-dense

runs the sparse plane against the dense one at 4096^2 and 8192^2 (the
R-pentomino x 1000, and 5% and 25% tile soups x 64 and x 1000, seven
times each in turns) and prints every wall and the median ratio, the
measurement behind ``SPARSE_MIN_CELLS`` (the main run's table, repeated).

    python3 chip_smoke.py --pod-layouts

runs the pod CLI on every card of a host of two or more (an even number):
the 16384^2 R-pentomino x 1000 from one process over every card, from two
ranks of half the cards each, and from one rank a card, each held against
the single card's tiled kernel, and the two-rank layout stopped at turn
500 and resumed; a line a run with its wall.

    python3 chip_smoke.py --k1-sweep

builds K1 and times its single board on every route at 512^2, 256^2,
128^2 and 640 x 384 (both word axes), and 160^2, 192^2, 224^2 and 960^2
(word axis 0): one block; the shared-memory loop on clusters of 2, 4, 8
and 16 blocks at halo depths 8, 16 and 32; the register loop on clusters
of 8 and 16 at depths 8, 10, 12, 16, 20, 24 and 32 (each clamped to the
band) and 2, 4 and 8 lines a thread; each held first against the plain
version (n in 0, 1, d - 1, d, d + 1, 100), then timed, 100 turns by the
profiler's device time and 4096 by events; on standard output the
register loop's registers and spills, one JSON line a route, and for
each board the plan's time against the shared-memory loop's plan and the
fastest routes, the measurement behind ``whole_board.cluster_plan``.

    python3 chip_smoke.py --workers-times [TREE]

runs phase 20b's workers run alone (a seeded 4096^2 soup x 1000 turns
over four in-process workers) on the port in TREE and prints its wall and
mean StripStep handler time as one JSON line, for the same comparison.

    python3 chip_smoke.py --observability

builds the kernels and runs phase 23 alone.

    python3 chip_smoke.py --tools

builds the kernels and runs phase 24 alone: the operator tools against
the port's roles on the card. The canary's session verb (128^2, K2) and
run verb (512^2, K1), 20 probes each, bit-exact; a broker started with
``-canary 1 -timeline 0.5 -metrics`` probing itself; loadgen's 1000
SessionRuns of 128^2 x 100 turns from 30 zipf tenants, Poisson at 200/s
and in bursts of 32, the tenant ledger equal to the session counters and
every board equal to a numpy oracle; four workers on the card serving a
resident-wire 4096^2 x 200 Run (W) equal to the device backend's; the
fleet collector over three brokers and the four workers, read by doctor
(no paging finding) and watch; history over the brokers' journals, flame
over the loadgen run's profile, regress over two bench rounds; a strip
corrupted in place found by the canary and its SLO rule; and the port's
analyzer and README lints over the checkout.

    python3 chip_smoke.py --alive

builds the kernels and runs phase 25 alone: K1's history mode (the alive
count after every turn in one launch) against its plain version on the
card, ``alive_history`` past K1's gate (1024^2, one tiled launch a turn),
every turn 1..10000 of the three check/alive goldens through
``alive_history`` (64^2 and 512^2 in one history launch each, 16^2 on the
byte stencil), the JAX package's control-plane soak on the card, and one
10000-turn history launch at 512^2 and 64^2 by CUDA events against phase
5's 10000 one-turn launches; it prints the history kernel's row as a
``{"history": ...}`` JSON line.

    python3 chip_smoke.py --soak [SECONDS]

builds the kernels and runs phase 26 alone: the JAX package's one-minute
on-card session soak (a 4096^2 R-pentomino ``big_session`` under the
2-second ticker, a mid-run snapshot, a pause, a checkpoint every 50,000
turns, then 'q', resumed from its last checkpoint to the same PGM) on its
timeline scaled to SECONDS (default 30, as the full smoke runs it; 60 is
that test's minute). Both phases share tests/torch_soak.py with the card's
tests.

Game of Life is integer-exact: every comparison is equality (tolerance 0).
"""

from __future__ import annotations

import contextlib
import csv
import filecmp
import gc
import io
import inspect
import json
import os
import pathlib
import queue
import re
import shutil
import socket
import subprocess
import sys
import threading
import time

REPO = pathlib.Path(__file__).resolve().parent
SEED = 20261016
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_OPS_PER_CLOCK_PER_SM = 64  # CUDA C++ Programming Guide, cc 9.0 table
#: phase 26's wall: the JAX package's one-minute soak timeline, halved so
#: that the full smoke stays well inside its time limit
SOAK_SECONDS = 30.0


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


def window_records(prof, pattern: str) -> list[tuple[str, float, float]]:
    """``(name, start, end)`` in us of every kernel whose name matches
    ``pattern`` in a trace, leaving out any that started before the window's
    first launch call (an ordinary or a cooperative launch): a record that
    arrives late from an earlier window carries that window's time."""
    from torch.autograd import DeviceType

    events = prof.events()
    calls = [ev.time_range.start for ev in events
             if ev.device_type == DeviceType.CPU
             and ev.name.startswith(("cudaLaunchKernel", "cudaLaunchCooperativeKernel"))]
    if not calls:
        return []
    first = min(calls)
    return [(ev.name, ev.time_range.start, ev.time_range.end) for ev in events
            if ev.device_type == DeviceType.CUDA and ev.time_range.start >= first
            and re.search(pattern, ev.name)]


def launch_calls(prof) -> int:
    """The calls in a trace that each leave one device record: kernel
    launches, asynchronous copies and sets."""
    from torch.autograd import DeviceType

    return sum(1 for ev in prof.events() if ev.device_type == DeviceType.CPU
               and ev.name.startswith(("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                                       "cudaMemcpyAsync", "cudaMemsetAsync")))


def window_kernels(prof, pattern: str) -> list[tuple[str, float]]:
    """``(name, device time in us)`` of ``window_records``."""
    return [(name, end - start) for name, start, end in window_records(prof, pattern)]


def device_span_ms(fn, kernel: str, launches: int, traces: int = 3,
                   fallback=None) -> tuple[float, int]:
    """``(ms, traces)``: the device span of one ``fn()`` that makes
    ``launches`` launches of the kernels named ``kernel`` (a regular
    expression), from the first one's start to the last one's end in the
    profiler's trace, so that the gaps between launches count. Only traces
    that hold all ``launches`` stand (see ``trace``); the least span of up
    to ``traces`` of them, out of up to twelve taken, and how many stood.
    If none stands, ``fallback()`` stands in with 0 traces, and a line says
    so."""
    fn()
    spans = []
    for _ in range(12):
        records = window_records(trace(fn), rf"::(?:{kernel})[<(]")
        if len(records) == launches:
            spans.append(max(end for _, _, end in records) - min(s for _, s, _ in records))
            if len(spans) == traces:
                break
    if spans:
        return min(spans) / 1e3, len(spans)
    check(fallback is not None, f"no trace of {kernel} held its {launches} launches")
    print(f"  device_span_ms: no trace of {kernel} held its {launches} launches; the "
          "fallback stands in")
    return fallback(), 0


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


_POD_CHILD = """
import json, runpy, sys
import numpy as np
import torch
import torch.distributed as dist

init_method, runs, ck_path = sys.argv[1:4]
dist.init_process_group("nccl", init_method=init_method, world_size=1, rank=0)
torch.cuda.set_device(0)
from gol_distributed_final_tpu_torch.ops import tiled
for args in json.loads(runs):
    sys.argv = ["gol_distributed_final_tpu_torch.pod"] + args
    try:
        runpy.run_module("gol_distributed_final_tpu_torch.pod", run_name="__main__")
    except SystemExit as exc:
        if exc.code:
            raise
launched = (tiled.launches, tiled.plain_calls)

# the collectives a pod of several ranks adds, through NCCL on this one:
# the broadcast and barrier of the gates, the all-gather of counts and
# votes, the sharded checkpoint's vote and its load
from gol_distributed_final_tpu_torch.bigboard import r_pentomino, seed_packed
from gol_distributed_final_tpu_torch.engine.checkpoint import (
    load_packed_checkpoint_sharded, try_write_checkpoint_sharded)
from gol_distributed_final_tpu_torch.models import CONWAY
from gol_distributed_final_tpu_torch.parallel import multihost
from gol_distributed_final_tpu_torch.parallel.bit_halo import ShardedBitPlane, packed_sharding
from gol_distributed_final_tpu_torch.parallel.mesh import ShardedBoard, make_mesh

assert dist.get_backend() == "nccl" and multihost.process_count() == 1
assert multihost.broadcast_int(7) == 7
multihost.barrier()
assert multihost.allgather(np.array([3, 4], np.int64)).tolist() == [[3, 4]]
mesh = make_mesh((2, 4), devices=[torch.device("cuda", 0)] * 8)
state = ShardedBoard.from_global(mesh, seed_packed(1024, r_pentomino(1024), device="cuda"))
assert try_write_checkpoint_sharded(ck_path, 3, CONWAY, ShardedBitPlane(mesh), state) is None
back, turn, rule, axis = load_packed_checkpoint_sharded(ck_path, packed_sharding(mesh))
assert turn == 3 and torch.equal(back.gather(), state.gather())
print("NCCL collectives ok")
print(f"POD_LAUNCHES tiled={launched[0]} plain={launched[1]}", flush=True)
dist.destroy_process_group()
"""


def pod_child(runs: list) -> str:
    """Run the pod CLI once for each argument list of ``runs``, in one
    child process of this checkout that has joined a one-rank NCCL group
    (``tcp://127.0.0.1:<free port>``, world size 1), then its collectives
    on their own; returns the child's output, which ends with its tiled
    launch count."""
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    ck = REPO / "out" / "chip_smoke" / f"nccl_ck_{port}.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _POD_CHILD, f"tcp://127.0.0.1:{port}", json.dumps(runs), str(ck)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=900,
    )
    check(proc.returncode == 0, f"pod child failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    for leftover in ck.parent.glob(ck.stem + "*"):
        leftover.unlink()
    return proc.stdout


def kernel_label(mangled: str) -> str:
    """A kernel instantiation's short name from its mangled one, e.g.
    ``tiled<0, 8, StaticRule<8, 0, 16>>``."""
    kernel = re.search(
        r"(whole_board_cluster_registers|whole_board_cluster|whole_board|tiled|byte_board_bits|byte_board_bytes|byte_board|byte_tiled|"
        r"sparse_blocks|sparse_step|sparse_scatter|sparse_dilate|sparse_list|strip_steps)_kernel",
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


#: K1's sweep: the boards (packed shape, word axis) and the routes: the
#: shared-memory loop on clusters of 2-16 blocks at three depths, the
#: register loop on clusters of 8 and 16 at seven depths (each clamped to
#: the band) and every compiled lines a thread
K1_SWEEP_BOARDS = (((16, 512), 0), ((512, 16), 1), ((8, 256), 0), ((256, 8), 1),
                   ((4, 128), 0), ((128, 4), 1), ((20, 384), 0), ((640, 12), 1),
                   ((5, 160), 0), ((6, 192), 0), ((7, 224), 0), ((30, 960), 0))
K1_SWEEP_CLUSTERS = (2, 4, 8, 16)
K1_SWEEP_DEPTHS = (8, 16, 32)
K1_SWEEP_REG_CLUSTERS = (8, 16)
K1_SWEEP_REG_DEPTHS = (8, 10, 12, 16, 20, 24, 32)


def k1_sweep_routes(whole_board, shape, axis) -> list:
    """The sweep's routes for one board (``whole_board.Route``s), the
    plan's among them, each once."""
    lines = shape[1] if axis == 0 else shape[0]
    routes = [whole_board.Route(1)]
    for c in K1_SWEEP_CLUSTERS:
        if lines % c == 0:
            routes += [whole_board.cluster_route(shape, axis, c, d) for d in K1_SWEEP_DEPTHS]
    for c in K1_SWEEP_REG_CLUSTERS:
        if lines % c == 0:
            routes += [route for d in K1_SWEEP_REG_DEPTHS
                       for per_thread in whole_board.REG_LINE_CHOICES
                       if (route := whole_board.cluster_route(shape, axis, c, d, per_thread)).warps]
    routes.append(whole_board.cluster_plan(shape, axis))
    return list(dict.fromkeys(routes))


def k1_sweep() -> int:
    """K1's single board on every route of the sweep (module docstring):
    each route held against the plain version, then timed: a counted
    launch of 100 turns by the profiler's device time (events there time
    the host's launch rate), of 4096 turns by CUDA events around
    back-to-back launches; per board the fastest routes, the plan's, and
    the shared-memory loop's on the plan's cluster at depth 16, or the band
    (``smem`` below)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from gol_distributed_final_tpu_torch.ops import _build, whole_board

    for name in ("whole_board", "byte_board"):
        _build.library_path(name).unlink(missing_ok=True)  # built now, so ptxas reports
    reports = _build.build(["whole_board", "byte_board"])
    ptxas = ptxas_summary(reports)
    for line in ptxas:
        print("ptxas", line)
    card = nvidia_smi("name,power.limit")
    print("card", card, nvidia_smi("clocks.sm,clocks.max.sm"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows = []
    summary = []
    for shape, axis in K1_SWEEP_BOARDS:
        packed = torch.from_numpy(
            rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)).to(dev)
        rows_n = shape[0]
        plain = {}

        def want(n):
            if n not in plain:
                plain[n] = whole_board.step_n_plain(packed, n, axis)
            return plain[n]

        plan = whole_board.cluster_plan(shape, axis)
        mine = []
        for route in k1_sweep_routes(whole_board, shape, axis):
            out = torch.empty_like(packed)
            counts = torch.empty(rows_n, dtype=torch.int32, device=dev)
            d = route.depth
            used = None
            for n in sorted({0, 1, max(d - 1, 0), d, d + 1, 100}):
                used = whole_board.launch_one(packed, out, counts, n, axis, 8, 12,
                                              "pallas.vmem_bit", route)
                torch.cuda.synchronize()
                board, row_counts = want(n)
                check(torch.equal(out, board) and torch.equal(counts, row_counts),
                      f"K1 sweep {shape} axis {axis} {route} n {n}: "
                      "differs from the plain version")
            row = {"shape": list(shape), "axis": axis, "route": list(route),
                   "ran": list(used), "plan": route == plan, "card": card}
            row["ms_n100"] = device_ms(lambda: whole_board.launch_one(
                packed, out, counts, 100, axis, 8, 12, "pallas.vmem_bit", route),
                r"whole_board\w*_kernel", reps=20)[0]
            row["ms_n4096"] = cuda_ms(lambda: whole_board.launch_one(
                packed, out, counts, 4096, axis, 8, 12, "pallas.vmem_bit", route), reps=5)
            rows.append(row)
            mine.append(row)
            print(json.dumps(row))
        shared = (whole_board.cluster_route(shape, axis, plan.blocks, 16) if plan.blocks > 1
                  else plan)
        by_route = {tuple(r["route"]): r for r in mine}
        for key in ("ms_n100", "ms_n4096"):
            best = sorted(mine, key=lambda r: r[key])[:4]
            planned = by_route[tuple(plan)][key]
            before = by_route[tuple(shared)][key]
            line = (f"{shape} axis {axis} {key}: plan {tuple(plan)} {planned:.5f}; smem "
                    f"{tuple(shared)} {before:.5f} ({planned / before:.3f}); one block "
                    f"{by_route[tuple(whole_board.Route(1))][key]:.5f}; best " + "; ".join(
                        f"{tuple(r['route'])} {r[key]:.5f}" for r in best))
            summary.append(line)
            print(line)
    for line in summary:
        print("summary", line)
    # the register loop, every lines a thread the plan may take, every rule
    # and both packings, spills nothing
    for per_thread in whole_board.REG_LINE_CHOICES:
        planned = [line for line in ptxas
                   if line.startswith(f"whole_board_cluster_registers<0, {per_thread},")
                   or line.startswith(f"whole_board_cluster_registers<1, {per_thread},")]
        check(len(planned) == 10 and all(line.endswith(" 0 spill bytes") for line in planned),
              f"the plan's register loop ({per_thread} lines a thread) spills: {planned}")
    print(json.dumps({"k1_sweep": len(rows), "card": card}))
    return 0


def sparse_launch_ms(st, tile, h, cap, blocks, reps=5) -> tuple[float, int]:
    """``(ms, ctas)``: the sparse kernel's own time for one dispatch of
    ``blocks`` blocks of ``h`` turns from the sparse state ``st``, by CUDA
    events around its cooperative launch alone, made as
    ``ops/sparse_tiles.py::dispatch`` makes it, from a copy of the board
    taken before the start event; the least of ``reps`` after a warm-up.
    Unlike the profiler's trace, which loses records late in a long run,
    events always see the launch. Checks the launch's board against the
    wrapper's dispatch, which must run every block."""
    import torch

    from gol_distributed_final_tpu_torch.ops import _build, bitpack, sparse_tiles

    lib = _build.load("sparse_tiles", sparse_tiles._SIGNATURES)
    dev = st.packed.device
    rows, cols = st.packed.shape
    stream = torch.cuda.current_stream().cuda_stream
    workspace = sparse_tiles._workspace(lib, dev, stream, rows, cols, tile, cap)
    board, out_grid = torch.empty_like(st.packed), torch.empty_like(st.grid)
    counts = torch.empty(blocks + 1, dtype=torch.int32, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps + 1):
        board.copy_(st.packed)
        start.record()
        err = lib.gol_sparse_dispatch(
            board.data_ptr(), st.grid.data_ptr(), out_grid.data_ptr(), counts.data_ptr(),
            workspace.data_ptr(), rows, cols, *tile, h, cap, blocks,
            *bitpack.rule_masks(8, 12), stream)
        end.record()
        check(err == 0, f"sparse launch failed with CUDA error {err}")
        end.synchronize()
        times.append(start.elapsed_time(end))
    want = sparse_tiles.dispatch(st.packed, st.grid, blocks, tile, h, cap, 8, 12)
    check(torch.equal(board, want.packed) and torch.equal(out_grid, want.grid),
          "the timed launch differs from the wrapper's dispatch")
    check(want.blocks_done == blocks, f"the timed dispatch stopped at {want.blocks_done}")
    return min(times[1:]), sparse_tiles.ctas(tile, h, cap, 8, 12)


#: variants of the sparse kernel for ``--sparse-sweep``: (name, [(text in
#: csrc/sparse_tiles.cu, its replacement)]), each a copy of this checkout's
#: port with the source edited so; every edit must apply
SPLIT_LINE = "        int split = kSplits - 1;\n"
GRID_LINE = ("    *ctas = static_cast<int>(std::min(want, static_cast<long long>(per_sm) * sms));"
             "\n")
SPARSE_VARIANTS = [
    ("as committed", []),
    ("tiles whole", [(SPLIT_LINE, "        int split = 0;\n")]),
    ("tiles whole, 224 threads", [(SPLIT_LINE, "        int split = 0;\n"),
                                  ("constexpr int kThreadAim = 512;",
                                   "constexpr int kThreadAim = 256;")]),
] + [(f"tiles whole on {n} CTAs", [
    (SPLIT_LINE, "        int split = 0;\n"),
    (GRID_LINE, f"    *ctas = std::min({n}, per_sm * sms);\n")]) for n in (48, 132, 160, 264)
] + [(f"as committed on {n} CTAs", [(GRID_LINE, f"    *ctas = std::min({n}, per_sm * sms);\n")])
     for n in (160, 264)] + [
    ("an OR barrier every turn", [("        __syncthreads();\n        uint32_t* tmp = cur;",
                                   "        mine = __syncthreads_or(mine);\n"
                                   "        uint32_t* tmp = cur;")]),
]


def sparse_sweep(out_dir: str) -> int:
    """Time each of ``SPARSE_VARIANTS``, one process a variant, each built
    from its own edited copy of the port under ``out_dir``; prints one
    JSON line a variant (``--sparse-times``)."""
    import shutil

    for name, edits in SPARSE_VARIANTS:
        tree = pathlib.Path(out_dir) / re.sub(r"\W+", "_", name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(REPO / "gol_distributed_final_tpu_torch",
                        tree / "gol_distributed_final_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        source = tree / "gol_distributed_final_tpu_torch" / "csrc" / "sparse_tiles.cu"
        text = source.read_text()
        for old, new in edits:
            check(text.count(old) == 1, f"variant {name!r}: {old!r} is not in the source once")
            text = text.replace(old, new)
        source.write_text(text)
        out = subprocess.run([sys.executable, __file__, "--sparse-times", str(tree), name],
                             capture_output=True, text=True)
        lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
        check(out.returncode == 0 and lines, f"variant {name!r}: {out.stdout[-2000:]}"
                                             f"{out.stderr[-2000:]}")
        print(lines[-1], flush=True)
    return 0


def sparse_times(tree: str, name: str) -> int:
    """The sparse kernel of the port in ``tree``, by ``sparse_launch_ms``:
    64-block dispatches of h = 8 and h = 1 from the 16384^2 R-pentomino
    after 1000 turns at the capacities its plane takes (64) and the timing
    phase's (128), one of 1024 blocks, and 4 blocks of a 16384^2 soup with
    5% of the tiles active at a capacity of every tile; one JSON line, ms
    per block."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import numpy as np
    import torch

    from gol_distributed_final_tpu_torch import bigboard
    from gol_distributed_final_tpu_torch.models import CONWAY
    from gol_distributed_final_tpu_torch.ops import bitpack, sparse

    check(pathlib.Path(sparse.__file__).is_relative_to(pathlib.Path(tree).resolve()),
          f"the port imported from {tree}")
    dev = torch.device("cuda")
    plane = sparse.SparseBitPlane(CONWAY, device=dev)
    st = plane.step_n(plane.from_packed(bigboard.seed_packed(16384, bigboard.r_pentomino(16384))),
                      1000)
    tile = sparse.sparse_tile_shape(tuple(st.packed.shape))
    ms = {"count": st.count}
    for cap in (64, 128):
        for h in (8, 1):
            t, ctas = sparse_launch_ms(st, tile, h, cap, 64)
            ms[f"rpent_cap{cap}_h{h}"] = t / 64
            ms[f"rpent_cap{cap}_ctas"] = ctas
    # a long launch (1024 blocks, 8192 turns): whether a block costs the
    # same when the card has been busy for milliseconds
    t, _ = sparse_launch_ms(st, tile, 8, 128, 1024, reps=2)
    ms["rpent_cap128_h8_1024blocks"] = t / 1024
    shape = bitpack.packed_shape(16384, 16384)
    rng = np.random.default_rng(SEED)
    chosen = rng.random((shape[0] // tile[0], shape[1] // tile[1])) < 1 - 0.95 ** (1 / 9)
    mask = np.repeat(np.repeat(chosen, tile[0], 0), tile[1], 1)
    words = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    soup = plane.from_packed(torch.from_numpy(np.where(mask, words, 0).astype(np.int32)))
    t, ctas = sparse_launch_ms(soup, tile, 8, chosen.size, 4)
    ms.update(soup_count=soup.count, soup_ctas=ctas, soup_5pct_n4=t / 4)
    print(json.dumps({"variant": name, "card": nvidia_smi("name,power.limit"), "ms": ms}))
    return 0


#: the sparse kernel's names in a trace, this design's and the earlier
#: one's (a list pass, then a step, a scatter and a dilate launch a block),
#: so that a parent tree is timed by the same yardstick
SPARSE_KERNELS = "sparse_(?:blocks|list|step|scatter|dilate)_kernel"


def timed_wall(fn):
    """``(seconds, fn())``: the wall of one call, synchronised both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return time.monotonic() - t0, out


def device_total_ms(fn) -> float:
    """All kernels' device time in a trace of one ``fn()``, the fullest of
    three traces (a trace may lose records, see ``trace``)."""
    fn()
    return max(sum(us for _, us in window_kernels(trace(fn), r".")) for _ in range(3)) / 1e3


def make_tile_soup(shape, tile, frac, seed, dev):
    """Random words in round(q x tiles) random tiles of ``tile`` words (at
    least one), q drawn so that about ``frac`` of the tiles are active once
    the occupancy grid is dilated (1 - (1 - q)^9 = frac); made on ``dev``."""
    import torch

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


def sparse_against_dense(dev, card_tag: str, sides, reps: int = 1, soups=(),
                         device_time: bool = False) -> dict:
    """The sparse plane against the dense one, the table behind
    SPARSE_MIN_CELLS (ops/sparse.py): at each side, the R-pentomino x 1000
    and each ``(fraction, turns)`` of ``soups`` (``make_tile_soup``)
    through ``SparseBitPlane`` (``from_packed`` included) and ``BitPlane``
    (the tiled kernel), their boards held equal after a warm-up; then the
    walls with a synchronise, the two planes in turns (sparse first on even
    repetitions), ``reps`` times each, and with ``device_time`` every
    kernel's device time in a trace of each. A line per case; returns
    ``{case: walls, the median dense/sparse wall ratio (>= 1: the sparse
    plane holds)}``."""
    import statistics

    import torch

    from gol_distributed_final_tpu_torch import bigboard
    from gol_distributed_final_tpu_torch.models import CONWAY
    from gol_distributed_final_tpu_torch.ops import bitpack, sparse
    from gol_distributed_final_tpu_torch.ops.plane import BitPlane
    from gol_distributed_final_tpu_torch.ops.sparse import SparseBitPlane

    rows = {}
    for side in sides:
        shape = bitpack.packed_shape(side, side)
        cases = [("R-pentomino", 1000, None)] + [(f"{frac:.0%} tile soup", turns, frac)
                                                   for frac, turns in soups]
        for pattern, turns, frac in cases:
            if frac is None:
                seed = bigboard.seed_packed(side, bigboard.r_pentomino(side), device=dev)
            else:
                seed = make_tile_soup(shape, sparse.sparse_tile_shape(shape), frac,
                                      side + int(frac * 1000), dev)
            sp, bp = SparseBitPlane(CONWAY, device=dev), BitPlane(CONWAY, 0, dev)

            def sparse_run():
                return sp.step_n(sp.from_packed(seed), turns).packed

            def dense_run():
                return bp.step_n(seed, turns)

            check(torch.equal(sparse_run(), dense_run()),
                  f"{side}^2 {pattern} x {turns}: the sparse and dense boards differ")
            walls = {"sparse": [], "dense": []}
            for rep in range(reps):
                order = (("sparse", sparse_run), ("dense", dense_run))
                for name, fn in (order if rep % 2 == 0 else order[::-1]):
                    walls[name].append(timed_wall(fn)[0])
            ratio = statistics.median(d / s for s, d in zip(walls["sparse"], walls["dense"]))
            row = {"sparse_s": walls["sparse"], "dense_s": walls["dense"],
                   "median_dense_over_sparse": ratio}
            dev_ms = {}
            if device_time:
                dev_ms = {"sparse": device_total_ms(sparse_run),
                          "dense": device_total_ms(dense_run)}
                row.update(sparse_device_ms=dev_ms["sparse"], dense_device_ms=dev_ms["dense"])
            rows[f"{side}^2 {pattern} x {turns}"] = row
            print(f"  {side}^2 {pattern} x {turns}: "
                  + ", ".join(f"{name} {', '.join(f'{w:.4f}' for w in walls[name])} s"
                              + (f" / {dev_ms[name]:.3f} ms" if dev_ms else "")
                              for name in ("sparse", "dense"))
                  + f"; median dense/sparse {ratio:.3f} {card_tag}")
            del seed
    return rows


def sparse_dense(reps: int = 7) -> int:
    """``--sparse-dense``: ``sparse_against_dense`` at 4096^2 and 8192^2,
    the R-pentomino x 1000 and 5% and 25% tile soups x 64 and x 1000,
    ``reps`` times each; one JSON line with every wall and ratio."""
    import torch

    from gol_distributed_final_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    _build.build()
    card = nvidia_smi("name,power.limit")
    print("sparse against dense (wall s):")
    rows = sparse_against_dense(torch.device("cuda"), f"[{card}]", (4096, 8192), reps,
                                soups=((0.05, 64), (0.25, 64), (0.05, 1000), (0.25, 1000)))
    print(json.dumps({"sparse_dense": rows, "card": card}))
    return 0


def pod_layouts(size: int = 16384, turns: int = 1000) -> int:
    """``--pod-layouts``: the pod CLI on every card of one host (an even
    number, at least two), the R-pentomino at ``size`` x ``turns``, in the
    three layouts a host of several cards can take: one process over every
    card (a (1, n) mesh: halos copied between cards in the process), two
    ranks of n/2 cards each (CUDA_VISIBLE_DEVICES; a (2, n/2) mesh: each
    row halo an NCCL message staged from several cards of a rank), and n
    ranks of one card each (-device cuda:r; an (n, 1) mesh). Each prints
    ``alive 156`` and its PGM, read back packed, equals the single card's
    tiled step_n; the two-rank layout also stops at half the turns with
    -ck -ck-every and resumes with -resume to the same PGM. One line a run
    with its wall (the processes' start included) and one JSON line."""
    import torch

    from gol_distributed_final_tpu_torch import bigboard
    from gol_distributed_final_tpu_torch.ops import _build, tiled

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    check(cards >= 2 and cards % 2 == 0,
          f"--pod-layouts needs an even number of cards, at least two; this host has {cards}")
    _build.build(("tiled",))
    card = nvidia_smi("name,power.limit")
    want = tiled.step_n(bigboard.seed_packed(size, bigboard.r_pentomino(size)), turns)
    halves = [",".join(map(str, range(h * cards // 2, (h + 1) * cards // 2))) for h in (0, 1)]
    layouts = {
        "one": (f"one process over {cards} cards, a (1, {cards}) mesh", [({}, "cuda")]),
        "two": (f"two ranks of {cards // 2} cards, a (2, {cards // 2}) mesh",
                [({"CUDA_VISIBLE_DEVICES": v}, "cuda") for v in halves]),
        "each": (f"{cards} ranks of one card, a ({cards}, 1) mesh",
                 [({}, f"cuda:{r}") for r in range(cards)]),
    }
    base = REPO / "out" / "chip_smoke" / "pod_layouts"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)

    def pod(ranks, tag, flags):
        """The pod CLI once, a process per rank with its environment and
        -device; every process is stopped on the way out. Returns the
        wall and rank 0's output."""
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        procs, logs = [], [base / f"{tag}.{r}.log" for r in range(len(ranks))]
        t0 = time.monotonic()
        try:
            for r, (env, device) in enumerate(ranks):
                group = [] if len(ranks) == 1 else [
                    "-coordinator", f"127.0.0.1:{port}", "-num-processes", str(len(ranks)),
                    "-process-id", str(r)]
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "gol_distributed_final_tpu_torch.pod",
                         "-size", str(size), *flags, *group, "-device", device],
                        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO), **env),
                        stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT))
            codes = [proc.wait(timeout=600) for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.monotonic() - t0
        outs = [log.read_text() for log in logs]
        check(codes == [0] * len(ranks),
              f"pod {tag}: exit codes {codes}\n" + "\n".join(o[-3000:] for o in outs))
        return wall, outs[0]

    rows = {}
    pgm = f"{size}x{size}x{turns}.pgm"
    for tag, (label, ranks) in layouts.items():
        wall, out = pod(ranks, tag, ["-turns", str(turns), "-out", str(base / tag)])
        check("alive 156\n" in out, f"pod {label}: rank 0 printed {out[-2000:]}")
        check(torch.equal(bigboard.load_packed_from_pgm(base / tag / pgm), want),
              f"pod {label}: its PGM differs from the single card's tiled step_n")
        rows[label] = wall
        print(f"pod {label}: {size}^2 R-pentomino x {turns}: alive 156, the PGM equal to the "
              f"single card's tiled step_n; wall {wall:.3f} s [{card}]")
    label, ranks = layouts["two"]
    ck = base / "ck" / "podck.npz"
    stop, _ = pod(ranks, "stop", ["-turns", str(turns // 2), "-out", str(base / "stop"),
                                  "-ck", str(ck), "-ck-every", str(turns // 2)])
    resumed, out = pod(ranks, "resumed", ["-turns", str(turns), "-out", str(base / "resumed"),
                                          "-ck", str(ck), "-resume"])
    check("alive 156\n" in out, f"pod {label}, resumed: rank 0 printed {out[-2000:]}")
    check(filecmp.cmp(base / "two" / pgm, base / "resumed" / pgm, shallow=False),
          f"pod {label}: resumed from turn {turns // 2}, its PGM differs")
    rows[f"{label}: stopped at {turns // 2}, resumed"] = [stop, resumed]
    print(f"pod {label}: stopped at turn {turns // 2} (-ck -ck-every {turns // 2}, wall "
          f"{stop:.3f} s) and resumed with -resume ({resumed:.3f} s): the same PGM [{card}]")
    shutil.rmtree(base)
    print(json.dumps({"pod_layouts": rows, "cards": cards, "card": card}))
    return 0


#: the card's ceilings obs/perf.py classifies against (KNOWN_CUDA_PEAKS)
H100_INT32_OPS_PER_S = 1.673e13

#: phase 23's spreads, set before its first run on the card: a site's
#: device time from its per-launch event pairs, over its launches, against
#: the kernel's own time at the same shape timed apart. Never below 0.8 of
#: it (events cannot read less than the kernel); at most 1.25 of it where a
#: launch outlasts its wrapper's host work (K1's 100s of turns), and at
#: most the session's wall per launch where it does not (K6's 8-turn
#: launches at 512^2: the pair then brackets the gap the host leaves).
EVENT_FLOOR, EVENT_CEIL = 0.8, 1.25


def obs_reset() -> None:
    """Every observability singleton of the port off and empty, as a
    process starts."""
    from gol_distributed_final_tpu_torch.obs import (
        accounting, critical, device, flight, journal, metrics, profiler, timeline, tracing,
    )

    timeline.disable()
    journal.disable()
    profiler.disable()
    metrics.enable(False)
    metrics.registry().reset()
    tracing.enable(False)
    tracing.tracer().reset()
    flight.enable(False)
    flight.recorder().reset()
    accounting.ledger().reset()
    critical.tracker().reset()
    device.reset_dispatch()
    device.reset_hbm()


def obs_on(trace: bool, samplers: bool = True) -> None:
    """What the controller's ``-metrics`` (and ``-trace``, and with
    ``samplers`` ``-timeline -profile``) flags turn on (__main__.py)."""
    from gol_distributed_final_tpu_torch.obs import flight, metrics, profiler, timeline, tracing

    metrics.enable()
    if samplers:
        timeline.enable(period=0.5)
        profiler.enable(period_ms=10.0, tag="controller")
    if trace:
        tracing.enable()
        tracing.set_process_name("controller")
        flight.enable()


def series(snap: dict, name: str) -> dict:
    for fam in snap["families"]:
        if fam["name"] == name:
            return {tuple(s["labels"]): s for s in fam["series"]}
    return {}


def observability(dev, board512, golden_counts, card_tag, open_window, close_window,
                  controller_main) -> dict:
    """Phase 23: the observability layer on the card (module docstring).
    Returns the numbers it printed."""
    import numpy as np
    import torch

    from gol_distributed_final_tpu_torch import Params, run
    from gol_distributed_final_tpu_torch.engine import EngineConfig
    from gol_distributed_final_tpu_torch.obs import device as obs_device
    from gol_distributed_final_tpu_torch.obs import metrics as obs_metrics
    from gol_distributed_final_tpu_torch.obs import perf as obs_perf
    from gol_distributed_final_tpu_torch.obs.status import fetch_status
    from gol_distributed_final_tpu_torch.ops import bitpack, byte_tiled, whole_board
    from gol_distributed_final_tpu_torch.ops.fused import fused_step_n
    from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker

    out_dir = REPO / "out" / "chip_smoke_obs"
    shutil.rmtree(out_dir, ignore_errors=True)
    params = Params(turns=10_000, image_width=512, image_height=512)
    name = params.output_filename + ".pgm"
    ceil = obs_perf.calibrate(torch.cuda.get_device_name(0))
    check(ceil.source == "known" and ceil.flops_per_s == H100_INT32_OPS_PER_S
          and ceil.bytes_per_s == HBM_BYTES_PER_S,
          f"obs/perf.py knows the card's ceilings, got {ceil}")
    found: dict = {}

    def session(step_n_fn, report: bool):
        """The 512^2 x 10000 session through run(); the count at each chunk
        boundary is read as the 2 s ticker reads it."""
        seen = {}

        def hook(engine, state, turn):
            seen[turn] = engine.retrieve(include_world=False).alive_count

        wall, result = timed_wall(lambda: run(
            params, images_dir=REPO / "images", out_dir=out_dir, tick_seconds=3600,
            engine_config=EngineConfig(step_n_fn=step_n_fn, chunk_hook=hook), report=report))
        check(result.turns_completed == 10_000, "phase 23: turns")
        bad = [t for t, c in seen.items() if c != golden_counts[t]]
        check(not bad, f"phase 23: counts differ from check/alive at turns {bad[:5]}")
        return wall, result, seen

    # 1. the session through run() (K1's cluster route under FusedBitPlane)
    # and through fused_step_n (K6: 512^2 is past K5's gate), each without
    # and with the flags; every launch counted, its site's events held
    # against it
    paths = (
        ("run()", None, {whole_board.CLUSTER_SITE: ("whole_board", whole_board)}),
        ("fused_step_n", fused_step_n, {"pallas.fused_byte": ("byte_tiled", byte_tiled)}),
    )
    p512 = bitpack.pack(board512, 0, dev)
    c512 = torch.from_numpy(board512.copy()).to(dev)
    kernel_ms = {
        # K1 a turn at n = 1000 a launch, events around the launch (far
        # longer than its host work); K6's own 8-turn launch from the
        # profiler's device time
        whole_board.CLUSTER_SITE: cuda_ms(
            lambda: whole_board.step_n(p512, 1000, counted=True), reps=5) / 1000,
        "pallas.fused_byte": device_ms(lambda: byte_tiled.step_n(c512, 8, turns_per_launch=8),
                                       "byte_tiled_kernel", reps=50)[0],
    }
    for label, step_n_fn, sites in paths:
        obs_reset()
        plain_wall, plain, plain_seen = session(step_n_fn, report=False)
        plain_pgm = (out_dir / name).read_bytes()
        obs_on(trace=True)
        open_window()
        wall, result, seen = session(step_n_fn, report=True)
        torch.cuda.synchronize()
        got = close_window(f"phase 23 {label}", [m for m, _ in sites.values()])
        stats = obs_device.dispatch_stats()
        snap = obs_metrics.registry().snapshot()
        report = json.loads((out_dir / f"report_{params.output_filename}.json").read_text())
        check(np.array_equal(result.world, plain.world), f"phase 23 {label}: the board "
              "with every flag differs from the run without")
        check((out_dir / name).read_bytes() == plain_pgm, f"phase 23 {label}: PGM bytes")
        common = set(seen) & set(plain_seen)
        check(all(seen[t] == plain_seen[t] for t in common), f"phase 23 {label}: counts")
        turns = series(snap, "gol_engine_turns_total")[()]["value"]
        check(turns == 10_000, f"phase 23 {label}: gol_engine_turns_total {turns}")
        check(set(stats) == set(sites), f"phase 23 {label}: sites {sorted(stats)}")
        check(obs_device.pending_launches() == 0, f"phase 23 {label}: unresolved pairs")
        hist = series(snap, "gol_kernel_dispatch_seconds")
        kinds = report["devices"]["local_devices"]
        check(kinds and kinds[0]["device_kind"] == torch.cuda.get_device_name(0),
              f"phase 23 {label}: the report's inventory {kinds}")
        hbm = {k: v for k, v in report["stage_timings"].items() if "hbm" in k}
        used = series(snap, "gol_device_hbm_bytes_in_use")[("0",)]["value"]
        limit = series(snap, "gol_device_hbm_bytes_limit")[("0",)]["value"]
        check(0 < used <= limit, f"phase 23 {label}: HBM in use {used} of {limit}")
        rows = {r["site"]: r for r in obs_perf.refresh_metrics(ceil)}
        for site, (module_name, _) in sites.items():
            s = stats[site]
            check(s["calls"] == got[module_name] == hist[(site,)]["count"],
                  f"phase 23 {label}: {site} timed {s['calls']} launches, "
                  f"{module_name} counted {got[module_name]}")
            ops_rate, byte_rate = s["flops"] / s["wall_s"], s["bytes_accessed"] / s["wall_s"]
            check(ops_rate <= ceil.flops_per_s and byte_rate <= ceil.bytes_per_s,
                  f"phase 23 {label}: {site} reads {ops_rate:.4g} int32/s, {byte_rate:.4g} B/s")
            per_launch_ms = s["wall_s"] * 1e3 / s["calls"]
            if site == whole_board.CLUSTER_SITE:
                own_ms = kernel_ms[site] * 10_000 / s["calls"]  # the same turns, same launches
                ceiling_ms = EVENT_CEIL * own_ms
            else:
                own_ms = kernel_ms[site]
                ceiling_ms = wall * 1e3 / s["calls"]
            check(EVENT_FLOOR * own_ms <= per_launch_ms <= ceiling_ms,
                  f"phase 23 {label}: {site} {per_launch_ms:.5f} ms a launch by its events, "
                  f"the kernel alone {own_ms:.5f} ms")
            found[site] = dict(launches=s["calls"], event_ms=per_launch_ms, kernel_ms=own_ms,
                               ops_per_s=ops_rate, bytes_per_s=byte_rate,
                               bound_class=rows[site]["bound_class"])
            print(f"phase 23 {label}: {site} ({module_name}) {s['calls']} launches timed by "
                  f"event pairs = the wrapper's count; {per_launch_ms:.5f} ms a launch by its "
                  f"events against {own_ms:.5f} ms for the kernel alone "
                  f"({per_launch_ms / own_ms:.3g}x); {ops_rate:.4g} int32 ops/s "
                  f"({100 * ops_rate / ceil.flops_per_s:.3g}% of the ceiling), "
                  f"{byte_rate:.4g} B/s ({100 * byte_rate / ceil.bytes_per_s:.3g}%), "
                  f"{rows[site]['bound_class']} {card_tag}")
        print(f"phase 23 {label}: 512^2 x 10000 with -metrics -report -trace -timeline "
              f"-profile: board, PGM and {len(seen)} chunk counts equal the run without "
              f"flags and check/alive; gol_engine_turns_total 10000; HBM in use "
              f"{int(used)} of {int(limit)} B ({hbm}); inventory {kinds[0]['device_kind']}; "
              f"wall {wall:.4f} s with the flags, {plain_wall:.4f} s without {card_tag}")
        obs_reset()

    # 2. a broker on the card with every server flag, a -server 512^2 x 100
    # session and 256 concurrent SessionRuns (phase 10's shape); its Status
    # read by the port's obs.status, the roofline rows classified there
    jdir = out_dir / "journal"
    proc = Proc(["-m", "gol_distributed_final_tpu_torch.rpc.broker", "-port", "0",
                 "-metrics", "-timeline", "0.5", "-trace", "-journal", str(jdir),
                 "-profile", "-session-capacity", "256"])
    try:
        addr = f"127.0.0.1:{proc.port('broker listening on :')}"
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            code = controller_main(["-server", addr, "-w", "512", "-h", "512",
                                    "-turns", "100", "-noVis"])
        check(code == 0 and filecmp.cmp(REPO / "out" / "512x512x100.pgm",
                                        REPO / "check" / "images" / "512x512x100.pgm",
                                        shallow=False),
              "phase 23 broker: the -server session's PGM")
        rng = np.random.default_rng(SEED)
        n_sess, side = 256, 128
        boards = np.where(rng.random((n_sess, side, side)) < 0.3, 255, 0).astype(np.uint8)
        budgets = [1 + (999 * i) // (n_sess - 1) for i in range(n_sess)]
        errors = []

        def one(i):
            rb = RemoteBroker(addr)
            try:
                res = rb.session_run(Params(turns=budgets[i], image_width=side,
                                            image_height=side),
                                     boards[i], session_id=i + 1, timeout=600)
                if res.turns_completed != budgets[i]:
                    errors.append((i, res.turns_completed))
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append((i, e))
            finally:
                rb.close()

        threads = [threading.Thread(target=one, args=(i,)) for i in range(n_sess)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(not errors and not any(t.is_alive() for t in threads),
              f"phase 23 broker: SessionRuns {errors[:3]}")
        # the first poll starts the broker's one calibration in the
        # background and publishes rates only; classes follow a poll later
        for _ in range(20):
            t0 = time.monotonic()
            payload = fetch_status(addr, timeout=30)
            poll_s = time.monotonic() - t0
            rows = obs_perf.rows_from_status(payload, ceil)
            if rows and all(r["class_source"] == "server" for r in rows):
                break
            time.sleep(0.5)
        check(rows and all(r["bound_class"] in obs_perf.BOUND_CLASSES
                           and r["class_source"] == "server" for r in rows),
              f"phase 23 broker: roofline rows {rows}")
        bsnap = payload["metrics"]
        sessions = series(bsnap, "gol_session_turns_total")[()]["value"]
        check(sessions == sum(budgets), f"phase 23 broker: session turns {sessions}")
        check(payload.get("timeline") and payload.get("journal") and payload.get("profile")
              and payload.get("trace_spans"), "phase 23 broker: the Status sections")
        print(f"phase 23 broker: -metrics -timeline -trace -journal -profile on the card; "
              f"a -server 512^2 x 100 session golden and {n_sess} SessionRuns "
              f"(gol_session_turns_total {int(sessions)}); Status read in {poll_s:.4f} s: "
              + "; ".join(f"{r['site']} {r.get('calls')} launches "
                          f"{1e3 * r.get('mean_dispatch_s', 0):.5f} ms {r['bound_class']}"
                          for r in rows) + f" {card_tag}")
        RemoteBroker(addr).super_quit()
        proc.proc.wait(timeout=120)
    finally:
        proc.stop()

    # 3. -trace-device: a torch.profiler trace of a 512^2 x 100 session
    # that holds the kernels' names and the engine.chunk ranges
    tdir = out_dir / "trace_device"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        code = controller_main(["-w", "512", "-h", "512", "-turns", "100", "-noVis",
                                "-trace-device", str(tdir)])
    obs_reset()
    traces = sorted(tdir.glob("torch_trace_*.json"))
    check(code == 0 and traces, "phase 23 trace-device: no trace written")
    events = json.loads(traces[-1].read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    chunks = sum(n == "engine.chunk" for n in names)
    k1 = sum(bool(re.search(r"whole_board_cluster(?:_registers)?_kernel", n)) for n in names)
    check(chunks > 0 and k1 > 0, f"phase 23 trace-device: {chunks} engine.chunk ranges, "
          f"{k1} whole-board kernels on a cluster")
    print(f"phase 23 trace-device: {traces[-1].name} holds {chunks} engine.chunk ranges and "
          f"{k1} records of K1's cluster route {card_tag}")

    # 4. the cost of the layer: the host time of one event pair, then the
    # 512^2 x 10000 sessions' walls with metrics off, on, on with -trace,
    # and with every flag, in turns, median of 3
    obs_reset()
    obs_on(trace=False, samplers=False)
    pairs = 2000
    stream = obs_device.timing_stream(dev)  # as a wrapper passes it
    t0 = time.perf_counter()
    for _ in range(pairs):
        obs_device.end("pallas.fused_byte", dev, obs_device.begin(dev, stream), 1.0, 1.0)
    t_pair = (time.perf_counter() - t0) / pairs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obs_device.resolve()
    t_fold = (time.perf_counter() - t0) / pairs
    found["pair_host_us"], found["fold_host_us"] = 1e6 * t_pair, 1e6 * t_fold
    ev_a, ev_b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev_a.record(stream)
    ev_b.record(stream)
    torch.cuda.synchronize()

    def host_us(fn, n=2000):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e6 * (time.perf_counter() - t0) / n

    parts = {
        "current_stream": host_us(lambda: torch.cuda.current_stream(dev)),
        "Event()": host_us(lambda: torch.cuda.Event(enable_timing=True)),
        "record": host_us(lambda: ev_a.record(stream)),
        "query": host_us(ev_b.query),
        "elapsed_time": host_us(lambda: ev_a.elapsed_time(ev_b)),
        "histogram observe": host_us(
            lambda: obs_device._ins.KERNEL_DISPATCH_SECONDS.labels("x").observe(1e-6)),
        "memory_stats": host_us(lambda: torch.cuda.memory_stats(0), 200),
        "memory_stats_as_nested_dict": host_us(
            lambda: torch.cuda.memory_stats_as_nested_dict(0), 200),
        "sample_hbm": host_us(obs_device.sample_hbm, 200),
    }
    found["host_parts_us"] = parts
    print(f"phase 23 overhead: one event pair costs {1e6 * t_pair:.2f} us of host time at the "
          f"launch and {1e6 * t_fold:.2f} us to fold in (mean of {pairs}); its parts, us a "
          f"call: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + f" {card_tag}")
    modes = {"off": None, "metrics": (False, False), "metrics+trace": (True, False),
             "every flag": (True, True)}
    for label, step_n_fn in (("fused_step_n", fused_step_n), ("run()", None)):
        walls = {m: [] for m in modes}
        for _ in range(3):
            for mode, on in modes.items():
                obs_reset()
                if on is not None:
                    obs_on(trace=on[0], samplers=on[1])
                walls[mode].append(session(step_n_fn, report=False)[0])
        obs_reset()
        med = {m: sorted(w)[1] for m, w in walls.items()}
        found[f"walls {label}"] = walls
        print(f"phase 23 overhead: 512^2 x 10000 through {label}, median of 3 in turns: "
              + ", ".join(f"{m} {med[m]:.4f} s ({100 * (med[m] / med['off'] - 1):+.2f}%)"
                          for m in modes)
              + f"; every wall {json.dumps(walls)} {card_tag}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return found


#: the verdicts the JAX package's obs/regress.py gives BENCH_r04.json against
#: BENCH_r05.json (tests/test_torch_obs_tools.py holds the two packages'
#: verdicts equal on every pair of rounds)
REGRESS_R04_R05 = {
    "c2_128_pallas_bitboard": "removed", "c3_512_engine_driven": "removed",
    "c4_4096_tiled_bitboard": "removed", "c5_16384_sparse_bigboard": "faster",
    "c5_65536_sparse_bigboard": "jitter", "c6_4096_mesh_tax": "new",
    "c6_4096_mesh_tax_wide8": "new", "c6_512_mesh_tax_wide8": "new",
}


def life_batch(boards, turns: int):
    """The numpy oracle over a stack of {0,255} boards ``[n, h, w]`` on the
    torus: each cell's 3x3 sum (itself included) from two separable passes;
    alive next turn when it is 3, or 4 with the cell alive."""
    import numpy as np

    b = (np.asarray(boards) != 0).astype(np.uint8)
    for _ in range(turns):
        rows = b + np.roll(b, 1, 2) + np.roll(b, -1, 2)
        box = rows + np.roll(rows, 1, 1) + np.roll(rows, -1, 1)
        b = ((box == 3) | ((box == 4) & (b == 1))).astype(np.uint8)
    return b * np.uint8(255)


def quantile(values, q: float) -> float:
    s = sorted(values)
    return s[min(len(s) - 1, int(q * len(s)))]


#: phase 24's loadgen runs: SessionRuns per arrival mode
LOADGEN_SESSIONS = 1000


def tools(dev, card_tag, open_window, close_window) -> dict:
    """Phase 24: the operator tools against the port's roles on ``dev``
    (module docstring). Returns the numbers it printed."""
    import numpy as np

    from gol_distributed_final_tpu_torch.obs import (
        accounting, doctor, fleet, flame, history, journal, metrics, profiler, regress, slo,
        timeline,
    )
    from gol_distributed_final_tpu_torch.obs.canary import (
        CanaryProber, _oracle_evolve, canary_board,
    )
    from gol_distributed_final_tpu_torch.obs.loadgen import LoadConfig, LoadGenerator
    from gol_distributed_final_tpu_torch.obs.status import fetch_status, scalar_value, series_map
    from gol_distributed_final_tpu_torch.obs.watch import Watcher
    from gol_distributed_final_tpu_torch.rpc import broker, faults, integrity
    from gol_distributed_final_tpu_torch.rpc import worker as rpc_worker
    from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker, RpcClient
    from gol_distributed_final_tpu_torch.rpc.protocol import Methods, Request

    out_dir = REPO / "out" / "chip_smoke_tools"
    shutil.rmtree(out_dir, ignore_errors=True)
    jdir, pdir = out_dir / "journal", out_dir / "profile"
    device = str(dev)
    sessions = LOADGEN_SESSIONS
    t_phase = time.monotonic()
    found: dict = {}
    obs_reset()
    metrics.enable()
    journal.enable(out_dir=jdir, role="broker")
    server_a, service_a = broker.serve(port=0, session_capacity=256, device=dev)
    addr_a = f"127.0.0.1:{server_a.port}"
    procs, stops = [], []
    try:
        # 1. the canary's two verbs against a broker on the card: SessionRun
        # (with a tagged mid-flight retrieve) at 128^2 batches onto K2, Run
        # at 512^2 runs K1; every probe bit-exact against the numpy oracle
        for verb, size, kernel in (("session", 128, "batch_board"), ("run", 512, "whole_board")):
            prober = CanaryProber(addr_a, size=size, turns=16, verb=verb, seed=SEED % 1000)
            open_window()
            try:
                probes = [prober.probe_once() for _ in range(20)]
            finally:
                prober.stop()
            got = close_window(f"phase 24 canary {verb}", [kernel])
            bad = [p for p in probes if p["result"] != "ok"]
            check(not bad, f"phase 24 canary {verb}: {bad[:2]}")
            lat = [p["latency_s"] for p in probes]
            found[f"canary {verb}"] = lat
            print(f"phase 24 canary: {len(probes)} {verb} probes at {size}^2 x 16 turns, each "
                  f"bit-exact against the oracle, {got[kernel]} {kernel} launches; latency "
                  f"p50 {1e3 * quantile(lat, 0.5):.3f} ms, max {1e3 * max(lat):.3f} ms "
                  f"{card_tag}")
        probes_a = series_map(metrics.registry().snapshot(), "gol_canary_probes_total")
        check(sorted((k, v["value"]) for k, v in probes_a.items() if v["value"])
              == [(("ok",), 40.0)], f"phase 24 canary: gol_canary_probes_total {probes_a}")

        # 2. a broker probing itself: -canary 1 -timeline 0.5 -metrics
        proc_b = Proc(["-m", "gol_distributed_final_tpu_torch.rpc.broker", "-port", "0",
                       "-device", device, "-canary", "1", "-timeline", "0.5", "-metrics",
                       "-journal", str(jdir)])
        procs.append(proc_b)
        addr_b = f"127.0.0.1:{proc_b.port('broker listening on :')}"

        def ok_probes():
            payload = fetch_status(addr_b, timeout=30)
            rule = {a["rule"]: a for a in payload.get("alerts") or []}.get("canary-failure")
            check(rule is not None and rule["state"] == "ok",
                  f"phase 24 -canary broker: canary-failure {rule}")
            probes = series_map(payload["metrics"], "gol_canary_probes_total")
            return (probes.get(("ok",)) or {}).get("value") or 0, probes

        # the first probe loads the kernels in that process; then a few
        # periods, and the count must have grown
        deadline = time.monotonic() + 120
        while ok_probes()[0] < 2:
            check(time.monotonic() < deadline, "phase 24 -canary broker: no probe in 120 s")
            time.sleep(0.5)
        oks = [ok_probes()[0]]
        time.sleep(3.0)
        got_b = ok_probes()
        oks.append(got_b[0])
        probes_b = got_b[1]
        failed = {k: v.get("value") for k, v in probes_b.items() if k != ("ok",)}
        check(oks[0] >= 2 and oks[1] > oks[0] and not any(failed.values()),
              f"phase 24 -canary broker: ok probes {oks}, others {failed}")
        print(f"phase 24 -canary broker: -canary 1 -timeline 0.5 -metrics probed itself, "
              f"gol_canary_probes_total{{ok}} {int(oks[0])} then {int(oks[1])} 3 s "
              f"later, no other result; the canary-failure rule ok {card_tag}")

        # 3. loadgen at the sessions bench shape: SessionRuns of 128^2 x 100
        # turns from 30 tenants drawn zipf, Poisson at 200/s, then bursts of
        # 32; the ledger reconciles exactly with the session counters and
        # every completed board equals the oracle's for its seed. The
        # profiler samples this process (the broker's driver thread among
        # its threads) for the flame graph below.
        prof = profiler.enable(period_ms=10.0, out_dir=str(pdir), tag="loadgen")
        ledger = accounting.ledger()
        finals: dict = {}
        want = None
        runs = {}
        for arrival in ("poisson", "burst"):
            cfg = LoadConfig(rate=200.0, sessions=sessions, arrival=arrival, burst=32,
                             tenants=30, tenant_dist="zipf", size=128, turns=100,
                             seed=SEED % 1000, timeout=600.0)
            before = dict(ledger.window().get("totals") or {})
            finals.clear()
            gen = LoadGenerator(addr_a, cfg,
                                on_reply=lambda i, res: finals.__setitem__(i, res.world))
            open_window()
            t0 = time.monotonic()
            summary = gen.run()
            wall = time.monotonic() - t0
            got = close_window(f"phase 24 loadgen {arrival}", ["batch_board"])
            check(summary["completed"] + summary["rejected_total"] + summary["errors"]
                  == summary["issued"] == sessions and not summary["errors"],
                  f"phase 24 loadgen {arrival}: {summary}")
            snap = metrics.registry().snapshot()
            totals = ledger.window().get("totals") or {}
            turns_metric = scalar_value(snap, "gol_session_turns_total")
            admitted = scalar_value(snap, "gol_sessions_admitted_total")
            check(totals.get("turns") == int(turns_metric)
                  and totals.get("sessions") == int(admitted),
                  f"phase 24 loadgen {arrival}: the ledger {totals} against the counters "
                  f"(turns {turns_metric}, admitted {admitted})")
            check(totals["sessions"] - before.get("sessions", 0) == summary["completed"]
                  and totals["turns"] - before.get("turns", 0) == 100 * summary["completed"],
                  f"phase 24 loadgen {arrival}: the ledger moved to {totals} from {before}")
            if want is None:  # both runs send the same seeded boards
                want = life_batch(np.stack([gen.board_for(i) for i in range(sessions)]),
                                  cfg.turns)
            wrong = [i for i, world in finals.items() if not np.array_equal(world, want[i])]
            check(len(finals) == summary["completed"] and not wrong,
                  f"phase 24 loadgen {arrival}: boards {wrong[:5]} differ from the oracle")
            a2f, e2e = summary["admit_to_first_turn"], summary["session_e2e"]
            runs[arrival] = dict(summary, wall=wall, batch_board=got["batch_board"])
            print(f"phase 24 loadgen {arrival}: {sessions} SessionRuns of 128^2 x 100 at "
                  f"200/s, 30 tenants zipf: issued {summary['issued']}, completed "
                  f"{summary['completed']}, rejected {summary['rejected_total']} "
                  f"{summary['rejected']}, every board equal to the oracle; admit to first "
                  f"turn p50 {a2f.get('p50_us', 0) / 1e3:.3f} ms, p99 "
                  f"{a2f.get('p99_us', 0) / 1e3:.3f} ms (a session's whole wall p50 "
                  f"{e2e.get('p50_us', 0) / 1e3:.3f} ms, p99 {e2e.get('p99_us', 0) / 1e3:.3f} "
                  f"ms); {summary['sessions_per_s']} "
                  f"sessions/s over {wall:.3f} s; the ledger equals the counters (turns "
                  f"{totals['turns']}, sessions {totals['sessions']}); "
                  f"{got['batch_board']} batch_board launches {card_tag}")
        prof.stop()
        collapsed = prof.write_artifacts(str(pdir), "loadgen")[0]
        profiler.disable()
        found["loadgen"] = runs

        # 4. four workers on the card and a workers broker, a resident-wire
        # 4096^2 x 200 Run (W on every strip batch) equal to broker A's own
        wservers = [rpc_worker.serve(0, device=dev) for _ in range(4)]
        stops += [s.stop for s, _ in wservers]
        waddrs = [f"127.0.0.1:{s.port}" for s, _ in wservers]
        server_c, service_c = broker.serve(port=0, backend="workers", worker_addresses=waddrs,
                                           wire="resident", halo_depth=8, device=dev)
        stops.append(service_c.shutdown)
        addr_c = f"127.0.0.1:{server_c.port}"
        soup = np.where(np.random.default_rng(SEED).random((4096, 4096)) < 0.3,
                        255, 0).astype(np.uint8)
        worlds = {}
        for addr in (addr_c, addr_a):
            client = RpcClient(addr)
            try:
                open_window()
                t0 = time.monotonic()
                res = client.call(Methods.BROKER_RUN, Request(
                    world=soup, turns=200, threads=4, image_width=4096, image_height=4096),
                    timeout=600)
                wall = time.monotonic() - t0
                got = close_window(f"phase 24 run at {addr}",
                                   ["strip_steps"] if addr == addr_c else [])
            finally:
                client.close()
            check(res.turns_completed == 200, f"phase 24 run at {addr}: {res.turns_completed}")
            worlds[addr] = (np.asarray(res.world), wall, got)
        check(np.array_equal(worlds[addr_c][0], worlds[addr_a][0]),
              "phase 24 workers: the 4096^2 x 200 board differs from the device backend's")
        print(f"phase 24 workers: 4096^2 x 200 over four workers on the card, resident wire, "
              f"depth 8: {worlds[addr_c][2]['strip_steps']} strip_steps launches, "
              f"{worlds[addr_c][1]:.3f} s, the board equal to the device backend's "
              f"({worlds[addr_a][1]:.3f} s) {card_tag}")

        # 5. the fleet over the three brokers and the four workers the
        # workers broker's roster names; doctor and watch read its Status
        collector = fleet.FleetCollector([addr_a, addr_b, addr_c], interval=0.5, timeout=30.0)
        for _ in range(2):
            collector.sweep()
        fleet_server = fleet.serve(collector, port=0)
        stops.append(fleet_server.stop)
        fleet_addr = f"127.0.0.1:{fleet_server.port}"
        t0 = time.monotonic()
        payload = fetch_status(fleet_addr, timeout=30)
        poll_s = time.monotonic() - t0
        targets = payload["fleet"]["targets"]
        check(len(targets) == 7 and sum(t["worker"] for t in targets) == 4
              and all(t["state"] == "ok" for t in targets),
              f"phase 24 fleet: targets {[(t['address'], t['state']) for t in targets]}")
        # the merge is exact: the sum over every target's own Status (the
        # in-process roles share this process's registry, so each counts it)
        scraped = list(payload["fleet"]["broker_status"].values()) + [
            fetch_status(a, worker=True, timeout=30) for a in waddrs]
        want_turns = sum(scalar_value(p.get("metrics") or {}, "gol_engine_turns_total") or 0
                         for p in scraped)
        merged_turns = scalar_value(payload["metrics"], "gol_engine_turns_total")
        check(want_turns and merged_turns == want_turns,
              f"phase 24 fleet: merged gol_engine_turns_total {merged_turns} != {want_turns}")
        statuses = doctor.collect(fleet_addr, [], timeout=30.0)
        findings = doctor.diagnose(statuses)
        pages = [f for f in findings if f["severity"] == "page"]
        check(findings and not pages, f"phase 24 doctor: {pages or 'no finding'}")
        frame, frame_ok = Watcher(fleet_addr, [], timeout=30.0).frame()
        panels = ("FLEET", "SESSIONS (multi-universe)", "WORKERS (roster health)") + (
            ("ROOFLINE (achieved per site)",) if dev.type == "cuda" else ())
        missing = [p for p in panels if p not in frame]
        check(frame_ok and not missing, f"phase 24 watch: panels {missing} missing")
        found["fleet poll s"] = poll_s
        print(f"phase 24 fleet: {len(targets)} targets ok (3 brokers, 4 workers), merged "
              f"gol_engine_turns_total {int(merged_turns)} = the targets' sum; its Status "
              f"polled in {poll_s:.4f} s; doctor: {len(findings)} findings, none paging "
              f"(top: {findings[0]['title']}); watch renders {', '.join(panels)} {card_tag}")

        # 6. the journals, the profile and the bench rounds
        RemoteBroker(addr_b).super_quit()
        proc_b.proc.wait(timeout=120)
        journal.disable()
        hist = history.build_history("chip_smoke", out_dir=str(jdir))
        admits = [e for e in hist["events"]
                  if e.get("kind") == "session.admit" and e.get("pid") == os.getpid()]
        admitted = scalar_value(metrics.registry().snapshot(), "gol_sessions_admitted_total")
        check(len(hist["nodes"]) >= 2 and len(admits) == int(admitted)
              and not hist["problems"],
              f"phase 24 history: {len(admits)} admits of {admitted}, nodes {hist['nodes']}, "
              f"problems {hist['problems'][:3]}")
        print(f"phase 24 history: {len(hist['segments'])} journal segments of "
              f"{len(hist['nodes'])} processes merged, {hist['events_total']} events; a "
              f"session.admit for each of the {int(admitted)} sessions admitted here {card_tag}")
        rows = flame.hot_rows(flame.load_collapsed(collapsed), top=10 ** 6)
        frames = [r for r in rows if "gol_distributed_final_tpu_torch/engine/sessions.py"
                  in r["frame"]]
        check(frames, f"phase 24 flame: no frame of engine/sessions.py in {collapsed.name}")
        print(f"phase 24 flame: {collapsed.name} folds {len(rows)} frames; "
              f"engine/sessions.py's {len(frames)}, hottest {frames[0]['frame']} "
              f"(cum {100 * frames[0]['cum_share']:.1f}%) {card_tag}")
        verdicts = regress.compare(regress.load_bench(REPO / "BENCH_r04.json"),
                                   regress.load_bench(REPO / "BENCH_r05.json"))
        got_verdicts = {name: v["verdict"] for name, v in verdicts.items()}
        code = subprocess.run([sys.executable, "-m", "gol_distributed_final_tpu_torch.obs."
                               "regress", "BENCH_r04.json", "BENCH_r05.json"], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=str(REPO)),
                              capture_output=True, text=True, timeout=120).returncode
        check(code == 0 and got_verdicts == REGRESS_R04_R05,
              f"phase 24 regress: exit {code}, {got_verdicts}")
        print(f"phase 24 regress: BENCH_r04.json -> BENCH_r05.json exit 0, "
              + ", ".join(f"{k} {v}" for k, v in got_verdicts.items()) + f" {card_tag}")

        # 7. a wrong board served: a worker's strip corrupted in place with
        # integrity off; the Run-verb canary reports it corrupt and the
        # canary-failure rule fires on the next tick
        board = canary_board(16, 0, 1)
        oracle, _ = _oracle_evolve(board, 16)

        def flip_matters(i: int) -> bool:
            flipped = board.copy()
            flipped.reshape(-1)[i] ^= 0xFF
            return not np.array_equal(_oracle_evolve(flipped, 16)[0], oracle)

        idx = next(i for i in range(board.size) if flip_matters(i))
        wserver, _ = rpc_worker.serve(0, device=dev)
        stops.append(wserver.stop)
        server_d, service_d = broker.serve(port=0, backend="workers",
                                           worker_addresses=[f"127.0.0.1:{wserver.port}"],
                                           wire="resident", device=dev)
        stops.append(service_d.shutdown)
        integrity.set_enabled(False)
        faults.configure(f"worker.strip_corrupt:corrupt:1:{idx}")
        tl = timeline.enable(period=60.0, start_thread=False, rules=[])
        prober = CanaryProber(f"127.0.0.1:{server_d.port}", size=16, turns=16, verb="run")
        try:
            tl.sample_once()
            out = prober.probe_once()
            tl.sample_once()
            rule = next(r for r in slo.default_rules() if r.name == "canary-failure")
            firing, value, detail = rule.evaluate(tl)
        finally:
            prober.stop()
            timeline.disable()
            faults.configure(None)
            integrity.set_enabled(True)
        check(out["result"] == "corrupt" and firing,
              f"phase 24 corrupt: {out}, rule firing {firing} ({detail})")
        print(f"phase 24 corrupt: a strip byte flipped in place (flat index {idx}) with "
              f"-integrity off; the Run-verb canary reported corrupt ({out['detail']}) and "
              f"canary-failure fired (value {value}) {card_tag}")

        # 8. the port's analyzer over the port's tree and the README lints
        for module in ("gol_distributed_final_tpu_torch.analysis",
                       "gol_distributed_final_tpu_torch.obs.lint"):
            proc = subprocess.run([sys.executable, "-m", module], cwd=REPO,
                                  env=dict(os.environ, PYTHONPATH=str(REPO)),
                                  capture_output=True, text=True, timeout=300)
            check(proc.returncode == 0, f"phase 24 {module}: {proc.stdout[-2000:]}")
            print(f"phase 24 {module}: exit 0, {proc.stdout.strip().splitlines()[-1]} {card_tag}")
        print(f"phase 24: {time.monotonic() - t_phase:.1f} s in all {card_tag}")
    finally:
        for stop in reversed(stops):
            stop()
        for proc in procs:
            proc.stop()
        service_a.shutdown()
        profiler.disable()
        journal.disable()
        obs_reset()
    shutil.rmtree(out_dir, ignore_errors=True)
    return found


def phase_alone(run, names) -> int:
    """Build the kernels and run one phase alone (``--observability``,
    ``--tools``): ``run(card_tag, open_window, close_window)`` with the
    launches of the kernel modules ``names`` counted in its windows, as the
    main run counts them."""
    import importlib

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from gol_distributed_final_tpu_torch.ops import _build

    card = nvidia_smi("name,power.limit")
    print(card)
    _build.build()
    mods = {n: importlib.import_module(f"gol_distributed_final_tpu_torch.ops.{n}")
            for n in names}

    def open_window():
        for m in mods.values():
            m.reset_counts()

    def close_window(label, expect):
        got = {n: m.launches for n, m in mods.items()}
        for n in expect:
            check(got[n] > 0, f"{label}: the {n} kernel never launched")
        check(not any(m.plain_calls for m in mods.values()),
              f"{label}: a plain version ran on the card")
        return got

    run(f"[{card}]", open_window, close_window)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def observability_only() -> int:
    """``--observability``: build the kernels and run phase 23 alone."""

    def run(card_tag, open_window, close_window):
        import torch

        from gol_distributed_final_tpu_torch.__main__ import main as controller_main
        from gol_distributed_final_tpu_torch.io.pgm import read_pgm

        with open(REPO / "check" / "alive" / "512x512.csv") as f:
            golden_counts = {int(r["completed_turns"]): int(r["alive_cells"])
                             for r in csv.DictReader(f)}
        observability(torch.device("cuda"), read_pgm(REPO / "images" / "512x512.pgm"),
                      golden_counts, card_tag, open_window, close_window, controller_main)

    return phase_alone(run, ("whole_board", "byte_tiled"))


def tools_only() -> int:
    """``--tools``: build the kernels and run phase 24 alone."""

    def run(card_tag, open_window, close_window):
        import torch

        tools(torch.device("cuda"), card_tag, open_window, close_window)

    return phase_alone(run, ("whole_board", "batch_board", "tiled", "strip_steps"))


def card_int32_rate() -> tuple[float, int, float]:
    """``(rate, SMs, MHz)``: the card's int32 rate for the bound, ops a
    clock an SM x SMs x the maximum SM clock nvidia-smi reports."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return INT32_OPS_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6, sms, max_sm_mhz


def soak_helpers():
    """tests/torch_soak.py, the session soaks the card's tests share
    (jax-free)."""
    sys.path.insert(0, str(REPO / "tests"))
    import torch_soak

    return torch_soak


def alive(dev, card_tag, open_window, close_window) -> dict:
    """Phase 25: the per-turn alive history. K1's history mode against its
    plain version on the card; then, counted in a window of its own, the
    three goldens through ``alive_history`` (64^2 and 512^2 in one history
    launch each, 16^2 on the byte stencil) and the control-plane soak on
    the card; then one 10000-turn history launch at 512^2 (and 64^2) by
    CUDA events against the 10000 one-turn launches of phase 5 (wall).
    Returns the history kernel's row of the kernels table."""
    import numpy as np
    import torch

    from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm
    from gol_distributed_final_tpu_torch.models import (
        CONWAY, DAY_AND_NIGHT, HIGHLIFE, SEEDS, LifeRule,
    )
    from gol_distributed_final_tpu_torch.ops import bitpack, stencil, whole_board
    from gol_distributed_final_tpu_torch.params import Params

    rng = np.random.default_rng(SEED + 25)
    rules = (CONWAY, HIGHLIFE, SEEDS, DAY_AND_NIGHT, LifeRule.from_rulestring("B36/S125"))
    # 64^2, 96x128 and 512^2 in both packings, a packed axis wider than a
    # block has threads, and a board at the gate (two copies = the opt-in
    # limit)
    gate = (227, 128)
    check(whole_board.smem_bytes(gate) == whole_board.smem_limit(dev),
          f"{gate} words fill the block's opt-in shared memory")
    shapes = [((2, 64), 0), ((64, 2), 1), ((3, 128), 0), ((96, 4), 1), ((16, 512), 0),
              ((512, 16), 1), ((1500, 4), 0), ((4, 1500), 1), (gate, 0), (gate, 1)]
    err = 0
    cases = 0
    for shape, word_axis in shapes:
        packed = torch.from_numpy(
            rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)).to(dev)
        for rule in rules:
            for n in (1, 300):
                got = whole_board.history(packed, n, word_axis, rule.birth_mask,
                                          rule.survive_mask)
                want = whole_board.history_plain(packed, n, word_axis, rule.birth_mask,
                                                 rule.survive_mask)
                torch.cuda.synchronize()
                e = max_abs_err(got, want)
                check(e == 0, f"history {shape} word_axis={word_axis} {rule.name} n={n}: "
                              f"max abs err {e}")
                err = max(err, e)
                cases += 1
    soup = np.where(rng.random((1024, 1024)) < 0.3, 255, 0).astype(np.uint8)
    p1024 = bitpack.pack(soup, 0, dev)
    check(not whole_board.fits(tuple(p1024.shape), dev), "1024^2 is past K1's gate")
    past = bitpack.alive_history(p1024, 200)
    e = int(np.abs(past.astype(np.int64)
                   - whole_board.history_plain(p1024, 200).cpu().numpy()).max())
    check(e == 0, f"alive_history past the gate (1024^2 x 200): max abs err {e}")
    print(f"phase 25 parity: the history kernel equals its plain version in {cases} cases "
          f"(64^2, 96x128, 512^2 in both packings, a 1500-word packed axis, a board at the "
          f"gate {gate}; 4 rules and B36/S125; n in 1/300), max abs err {err}; alive_history "
          f"past the gate (1024^2 x 200, one tiled launch a turn) equals it too {card_tag}")

    open_window()
    golden = {}
    for size in (16, 64, 512):
        with open(REPO / "check" / "alive" / f"{size}x{size}.csv") as f:
            counts = {int(r["completed_turns"]): int(r["alive_cells"]) for r in csv.DictReader(f)}
        golden[size] = np.array([counts[t] for t in range(1, 10_001)], np.int32)
    boards = {size: read_pgm(REPO / "images" / f"{size}x{size}.pgm") for size in (16, 64, 512)}
    sweeps = {}
    for size in (64, 512):
        before = whole_board.history_launches
        t0 = time.monotonic()
        got = bitpack.alive_history(bitpack.pack(boards[size], 0, dev), 10_000)
        sweeps[size] = time.monotonic() - t0
        check(whole_board.history_launches - before == 1,
              f"{size}^2 x 10000: {whole_board.history_launches - before} history launches")
        bad = np.nonzero(got != golden[size])[0]
        check(bad.size == 0, f"{size}^2 history differs from check/alive at turns {bad[:5] + 1}")
    t0 = time.monotonic()
    got = stencil.alive_history(torch.from_numpy(boards[16].copy()).to(dev), 10_000)
    sweeps[16] = time.monotonic() - t0
    bad = np.nonzero(got != golden[16])[0]
    check(bad.size == 0, f"16^2 history differs from check/alive at turns {bad[:5] + 1}")
    print(f"phase 25 goldens: every turn 1..10000 of check/alive through alive_history: 64^2 "
          f"and 512^2 in one history launch each (wall {sweeps[64]:.3f} s and "
          f"{sweeps[512]:.3f} s with the read-back), 16^2 on the byte stencil in torch ops on "
          f"the card ({sweeps[16]:.3f} s) {card_tag}")

    helpers = soak_helpers()
    soak = helpers.control_plane_soak(REPO / "out" / "chip_smoke" / "soak25", dev,
                                      turns=helpers.CARD_TURNS)
    check(soak["done"] < helpers.CARD_TURNS, "phase 25: the soak's session was not ended by 'q'")
    ticks = soak["ticks"]
    print(f"phase 25 control-plane soak: the JAX package's seeded p/s key stream on a 64^2 "
          f"run() on the card: {len(ticks)} AliveCellsCount ticks (turns "
          f"{ticks[0].completed_turns}..{ticks[-1].completed_turns}) each equal to the history "
          f"at its turn, the final board equal to the state at turns_completed "
          f"{soak['done']} (of a budget of {helpers.CARD_TURNS}, ended by 'q') {card_tag}")
    got = close_window("phase 25", ["whole_board"])
    history_launches = whole_board.history_launches
    check(history_launches == 3, f"phase 25: {history_launches} history launches, want 3")
    check(whole_board.history_plain_calls == 0, "phase 25: the history's plain version ran")
    print(f"phase 25 launches: {history_launches} history launches (64^2, 512^2, the soak's "
          f"oracle) and {got['whole_board']} step launches of K1 (the soak's session), out of "
          f"the main path's counts {card_tag}")

    # one 10000-turn history launch against phase 5's 10000 one-turn launches
    p512 = bitpack.pack(boards[512], 0, dev)
    p64 = bitpack.pack(boards[64], 0, dev)
    ms512 = cuda_ms(lambda: whole_board.history(p512, 10_000), reps=5)
    ms64 = cuda_ms(lambda: whole_board.history(p64, 10_000), reps=5)
    plain_ms = cuda_ms(lambda: whole_board.history_plain(p512, 10_000), reps=1, warmup=0)
    seen = {}

    def record(engine, state, turn):
        seen[turn] = engine.retrieve(include_world=False).alive_count

    engine = Engine(EngineConfig(max_chunk=1, chunk_hook=record, device=dev))
    t0 = time.monotonic()
    engine.run(Params(turns=10_000, image_width=512, image_height=512), boards[512])
    per_turn_wall = time.monotonic() - t0
    check(all(seen[t] == golden[512][t - 1] for t in range(1, 10_001)),
          "phase 5's one-turn reading differs from check/alive")
    rate = card_int32_rate()[0]

    def bound(words, turns):
        ops, nbytes = whole_board.history_cost(
            words, turns, CONWAY.birth_mask, CONWAY.survive_mask, 4 * turns)
        t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes > t_ops else "operations")

    b512, by512 = bound(p512.numel(), 10_000)
    b64, _ = bound(p64.numel(), 10_000)
    print(f"timing history: one 10000-turn history launch {ms512:.4f} ms at 512^2 "
          f"({ms512 * 1e3 / 10_000:.4f} us/turn; bound {b512:.5f} ms ({by512}), "
          f"{ms512 / b512:.3g}x) and {ms64:.4f} ms at 64^2 (bound {b64:.5f} ms, "
          f"{ms64 / b64:.3g}x), by CUDA events; phase 5's 10000 one-turn launches with a "
          f"count read each take {per_turn_wall:.3f} s of wall ({per_turn_wall * 1e3 / ms512:.1f}x "
          f"the one launch); the plain version {plain_ms:.1f} ms {card_tag}")
    return {
        "name": "whole_board_history",
        "route": "cuda",
        "source": "gol_distributed_final_tpu_torch/csrc/whole_board.cu",
        "replaces": "gol_distributed_final_tpu/ops/bitpack.py:363",
        "launches": history_launches,
        "max_abs_err": err,
        "ms": ms512,
        "plain_ms": plain_ms,
        "bound_ms": b512,
        "bound_by": by512,
        "library_ms": None,
    }


def session_soak_phase(dev, seconds: float, card_tag, open_window, close_window) -> None:
    """Phase 26: the on-card session soak (tests/torch_soak.py), the JAX
    package's one-minute timeline scaled to ``seconds``: a 4096^2
    R-pentomino ``big_session`` under the 2-second ticker with a mid-run
    snapshot, a pause and a checkpoint every 50,000 turns, ended by 'q',
    then resumed from its last checkpoint to the same PGM."""
    from gol_distributed_final_tpu_torch.ops import tiled

    out_dir = REPO / "out" / "chip_smoke" / "soak26"
    shutil.rmtree(out_dir, ignore_errors=True)
    open_window()
    seen = soak_helpers().session_soak(out_dir, dev, size=4096, seconds=seconds)
    got = close_window("phase 26", ["tiled"])
    check(tiled.plain_calls == 0, "phase 26: the tiled kernel's plain version ran")
    print(f"phase 26 session soak: 4096^2 R-pentomino big_session for the JAX soak's timeline "
          f"scaled to {seconds:g} s: {seen['turns']} turns in {seen['wall']:.2f} s of wall, "
          f"{seen['ticks']} monotone ticks, one pause, the mid-run snapshot, the last "
          f"checkpoint at turn {seen['checkpoint_turn']}, resumed from it "
          f"({seen['turns'] - seen['checkpoint_turn']} turns) to the same PGM byte for byte, "
          f"{seen['alive']} alive at the end; {got['tiled']} tiled launches (out of "
          f"the main path's counts); big_session steps a BitPlane, auto_plane gives 4096^2 "
          f"{seen['auto_plane']} {card_tag}")
    shutil.rmtree(out_dir, ignore_errors=True)


def alive_only() -> int:
    """``--alive``: build the kernels and run phase 25 alone."""

    def run(card_tag, open_window, close_window):
        import torch

        row = alive(torch.device("cuda"), card_tag, open_window, close_window)
        print(json.dumps({"history": row}))

    return phase_alone(run, ("whole_board", "tiled"))


def soak_only(seconds: float) -> int:
    """``--soak [SECONDS]``: build the kernels and run phase 26 alone."""

    def run(card_tag, open_window, close_window):
        import torch

        session_soak_phase(torch.device("cuda"), seconds, card_tag, open_window, close_window)

    return phase_alone(run, ("whole_board", "tiled"))


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
    # K1's single board at 512^2, 256^2, 192^2 and 128^2, counted, at 100
    # turns and at the engine's 4096-turn chunk, on the route the tree picks
    # and, where the tree has a choice of routes, on one block; its history
    # mode at 512^2 x 10000 where the tree has it
    takes_route = hasattr(whole_board, "launch_one")
    if takes_route:  # one block: a Route, or the older trees' cluster 1
        block_route = ((whole_board.Route(1),) if hasattr(whole_board, "cluster_route")
                       else (1,))
    if hasattr(whole_board, "history"):
        times["history_512_n10000"] = cuda_ms(lambda: whole_board.history(p512, 10_000),
                                              reps=5)
    k1_boards = {512: p512, 256: words((8, 256)), 192: words((6, 192)), 128: words((4, 128))}
    for side, packed in k1_boards.items():
        out = torch.empty_like(packed)
        counts = torch.empty(packed.shape[0], dtype=torch.int32, device=dev)
        for n, reps in ((100, 50), (4096, 5)):
            times[f"k1_{side}_n{n}"] = cuda_ms(
                lambda: whole_board.step_n(packed, n, counted=True), reps=reps)
            if takes_route:
                times[f"k1_{side}_n{n}_block"] = cuda_ms(lambda: whole_board.launch_one(
                    packed, out, counts, n, 0, 8, 12, "pallas.vmem_bit", *block_route),
                    reps=reps)
    device["k1_512_n100"] = device_ms(lambda: whole_board.step_n(p512, 100, counted=True),
                                      "whole_board(?:_cluster(?:_registers)?)?_kernel",
                                      reps=20)[0]
    if (pathlib.Path(tree) / "gol_distributed_final_tpu_torch" / "ops" / "sparse_tiles.py").exists():
        # the sparse kernel, in the trees that have it, by one yardstick for
        # any design: the device span of a dispatch (its first sparse
        # kernel's start to its last one's end, the gaps between launches
        # included) over its blocks. One 8-turn block on 16384^2 with random
        # words in about 5% of the default tiles, and a 64-block dispatch
        # from the R-pentomino after 1000 turns at 16384^2 and 65536^2; the
        # launches a dispatch makes come from the tree's own count
        from gol_distributed_final_tpu_torch import bigboard
        from gol_distributed_final_tpu_torch.models import CONWAY
        from gol_distributed_final_tpu_torch.ops import sparse, sparse_tiles

        pattern = SPARSE_KERNELS

        def sparse_launches(fn):
            torch.cuda.synchronize()
            sparse_tiles.reset_counts()
            fn()
            torch.cuda.synchronize()
            return sparse_tiles.launches

        tile = sparse.sparse_tile_shape((512, 16384))
        chosen = torch.from_numpy(rng.random((512 // tile[0], 16384 // tile[1])) < 0.0057)
        mask = chosen.to(dev).repeat_interleave(tile[0], 0).repeat_interleave(tile[1], 1)
        soup = torch.where(mask, t16k, torch.zeros_like(t16k))
        grid = sparse.occupancy_grid(soup, *tile)
        cap = sparse._pow2_ceil(grid.numel())

        def block():
            return sparse_tiles.dispatch(soup, grid, 1, tile, 8, cap, 8, 12)

        n = sparse_launches(block)
        device["sparse_16384_5pct_block"] = device_ms(block, pattern, reps=20,
                                                      per_call=n)[0] * n
        times["sparse_16384_5pct_block"] = cuda_ms(block, reps=20)
        soup_clone = cuda_ms(lambda: soup.clone(), reps=20)
        device["sparse_16384_5pct_block_span"] = device_span_ms(
            block, pattern, n,
            fallback=lambda: times["sparse_16384_5pct_block"] - soup_clone)[0]
        for side in (16384, 65536):
            plane = sparse.SparseBitPlane(CONWAY, device=dev)
            st = plane.step_n(plane.from_packed(
                bigboard.seed_packed(side, bigboard.r_pentomino(side))), 1000)
            check(plane.alive_count(st) == 156, f"{side}^2 R-pentomino at turn 1000")
            tile = sparse.sparse_tile_shape(tuple(st.packed.shape))
            total = (st.packed.shape[0] // tile[0]) * (st.packed.shape[1] // tile[1])
            cap = min(sparse._pow2_ceil(max(st.count, 8) * 4), sparse._pow2_ceil(total))

            def dispatch64():
                return sparse_tiles.dispatch(st.packed, st.grid, 64, tile, 8, cap, 8, 12)

            check(dispatch64().blocks_done == 64, f"{side}^2: the timed dispatch stopped early")
            n = sparse_launches(dispatch64)
            key = f"sparse_{side}_rpent_block"
            wall = cuda_ms(dispatch64, reps=5, warmup=1)
            clone = cuda_ms(lambda: st.packed.clone(), reps=10)
            device[f"{key}_span"] = device_span_ms(dispatch64, pattern, n,
                                                   fallback=lambda: wall - clone)[0] / 64
            device[key] = device_ms(dispatch64, pattern, reps=3, per_call=n)[0] * n / 64
            times[f"sparse_{side}_rpent_dispatch64"] = wall
            times[f"sparse_{side}_rpent_dispatch64_less_clone"] = wall - clone
            times[f"sparse_{side}_launches_per_dispatch64"] = n
            del plane, st
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
    int32_rate, sms, max_sm_mhz = card_int32_rate()
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
                       ("whole_board", ("whole_board_cluster_kernelILi0E", conway)),
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
                    block, block_counts = torch.empty_like(packed), torch.empty_like(got_counts)
                    whole_board.launch_one(packed, block, block_counts, n, word_axis,
                                           rule.birth_mask, rule.survive_mask,
                                           "pallas.vmem_bit", whole_board.Route(1))
                    torch.cuda.synchronize()
                    err = max(max_abs_err(got, want), max_abs_err(got_counts, want_counts),
                              max_abs_err(block, want), max_abs_err(block_counts, want_counts))
                    check(err == 0, f"whole-board {size}^2 {rule.name} n={n} "
                                    f"word_axis={word_axis}: max abs err {err}")
                    k1_err = max(k1_err, err)
                    k1_cases += 1
    print(f"phase 3 parity: whole-board kernel equals its plain version in "
          f"{k1_cases} cases (64^2 and 512^2, 4 rules and B36/S125, n in 1/7/100, both "
          f"packings, counts), on the plan's route (512^2: a cluster of "
          f"{whole_board.cluster_plan((16, 512))[0]}) and on one block")

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
            packed = make_tile_soup(shape, tile, frac, size + int(frac * 100), dev)
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
        make_tile_soup(shape65, tile65, 0.01, 65536, dev), tile65, seed=1)))
    edge_boards.append(("65536^2 torus-edge tiles alone", tile65, (8,), with_edge_tiles(
        torch.zeros(shape65, dtype=torch.int32, device=dev), tile65, seed=2)))
    shape512 = bitpack.packed_shape(512, 512)
    tile512 = sparse.sparse_tile_shape(shape512)
    edge_boards.append(("512^2 soup and torus-edge tiles", tile512, range(1, 9), with_edge_tiles(
        make_tile_soup(shape512, tile512, 0.2, 512, dev), tile512, seed=3)))
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
    packed = make_tile_soup(shape4k, tile4k, 0.05, 7, dev)
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
    # long dispatches, one launch each: 64 blocks of 8 turns and 512 of one
    # that stop midway, the R-pentomino outgrowing a capacity of 32 tiles
    # and a soup settling into still lifes alone (seed 53's, at turn 320);
    # a frontier past the CTAs the card holds at once (a 16384^2 soup with
    # half the tiles active, capacity every tile), so that each CTA walks
    # several tiles a block; and that dispatch 20 times, bitwise equal each
    # time (a race between the kernel's phases would show as a difference)
    def settling_soup(seed):
        soup_rng = np.random.default_rng(seed)
        board = np.zeros((128, 128), np.uint8)
        board[50:66, 50:66] = np.where(soup_rng.random((16, 16)) < 0.4, 255, 0)
        return board

    long_runs = []
    for label, board, tile, capacity, kind in (
            ("R-pentomino 256^2", rpent(256, 256), (1, 16), 32, "overflow"),
            ("soup 128^2 settling into still lifes", settling_soup(53), (1, 8), 64, "drain")):
        packed = bitpack.pack(board, 0, dev)
        for n_blocks, h_turns in ((64, 8), (512, 1)):
            sparse_tiles.reset_counts()
            err, run_ = sparse_case(f"{label}, {n_blocks} blocks of h={h_turns}", packed, tile,
                                    h_turns, capacity, CONWAY, n_blocks=n_blocks)
            check(sparse_tiles.launches == 1,
                  f"a dispatch of {n_blocks} blocks made {sparse_tiles.launches} launches")
            stopped = run_.overflow if kind == "overflow" else (run_.count == 0
                                                                and not run_.overflow)
            check(0 < run_.blocks_done < n_blocks and stopped,
                  f"sparse {label}, {n_blocks} blocks: {run_[2:]}, want a midway {kind}")
            long_runs.append(f"{label} {n_blocks} x h={h_turns}: {kind} after "
                             f"{run_.blocks_done}")
            sp_err, sp_cases = max(sp_err, err), sp_cases + 1
            sp_overflows += run_.overflow
    shape16 = bitpack.packed_shape(16384, 16384)
    tile16 = sparse.sparse_tile_shape(shape16)
    total16 = (shape16[0] // tile16[0]) * (shape16[1] // tile16[1])
    packed = make_tile_soup(shape16, tile16, 0.5, 16385, dev)
    count = int(sparse.occupancy_grid(packed, *tile16).sum())
    ctas16 = sparse_tiles.ctas(tile16, 8, total16, 8, 12)
    check(count > 2 * ctas16, f"16384^2 soup: {count} active tiles on {ctas16} CTAs")
    err, first = sparse_case(f"16384^2 {count}/{total16} active on {ctas16} CTAs", packed,
                             tile16, 8, total16, CONWAY)
    sp_err, sp_cases = max(sp_err, err), sp_cases + 1
    grid16 = sparse.occupancy_grid(packed, *tile16)
    for _ in range(19):
        again = sparse_tiles.dispatch(packed, grid16, 3, tile16, 8, total16, 8, 12)
        check(torch.equal(again.packed, first.packed) and torch.equal(again.grid, first.grid)
              and again[2:] == first[2:], "a repeated sparse dispatch differs from the first")
    print(f"phase 3 parity: sparse long dispatches, one launch each, equal the plain program: "
          f"{'; '.join(long_runs)}; 16384^2 with {count} of {total16} tiles active on "
          f"{ctas16} CTAs ({count / ctas16:.1f} tiles a CTA a block) equal, and 20 runs of it "
          "bitwise equal")
    del packed, grid16, first, again
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
        else:
            dense16 = eng6.final_state()  # phases 21 and 22 are held against it
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


    # 21. the mesh planes on one card: a (2, 4) mesh of eight shards on
    # cuda:0 (parallel/mesh.py), each block stepped by the tiled kernel
    # over its exchanged halos. The 16384^2 R-pentomino x 1000 through
    # Engine.run on ShardedBitPlane at depth 1 and 8: 156 alive, the board
    # equal to phase 6's single-board one, and the tiled launches exactly
    # 8 x the exchanges of each chunk (parallel/halo.exchanges_per_dispatch)
    from gol_distributed_final_tpu_torch.parallel import (
        make_engine_step, sharded_bit_step_n_fn,
    )
    from gol_distributed_final_tpu_torch.parallel.bit_halo import ShardedBitPlane
    from gol_distributed_final_tpu_torch.parallel.halo import exchanges_per_dispatch
    from gol_distributed_final_tpu_torch.parallel.mesh import ShardedBoard, make_mesh

    from gol_distributed_final_tpu_torch.parallel.halo import _extend

    mesh24 = make_mesh((2, 4), devices=[dev] * 8)
    soup21 = random_words(bitpack.packed_shape(4096, 4096))
    soup21_want = tiled.step_n(soup21, 100)  # the single-board kernel, before the window
    # the tiled kernel at the shapes the mesh path gives it, before the
    # window: one haloed block of random words at each depth of this phase
    # (16384^2: 258 x 4098 at depth 1, 272 x 4112 at depth 8; the 4096^2
    # soup: 66 x 1026, 70 x 1030 and 80 x 1040), a launch of `depth` turns
    # against its plain version on the same block
    ext_shapes = []
    for board21, depths in ((random_words(bitpack.packed_shape(size16, size16)), (1, 8)),
                            (soup21, (1, 3, 8))):
        blocks21 = ShardedBoard.from_global(mesh24, board21).blocks
        for depth in depths:
            ext = _extend(blocks21, mesh24, k=depth)[1, 3]
            err = max_abs_err(tiled.step_n(ext, depth, turns_per_launch=depth),
                              tiled.step_n_plain(ext, depth, turns_per_launch=depth))
            check(err == 0, f"tiled kernel on a {tuple(ext.shape)} haloed block, {depth} "
                            f"turns: max abs err {err}")
            tiled_err = max(tiled_err, err)
            ext_shapes.append(tuple(ext.shape))
        del blocks21, board21
    torch.cuda.synchronize()
    open_window()
    walls21 = {}
    for depth in (1, 8):
        plane21 = ShardedBitPlane(mesh24, CONWAY, 0, halo_depth=depth)
        gates21 = [0]
        eng21 = Engine(EngineConfig(final_world=False,
                                    chunk_hook=lambda e, s, t: gates21.append(t)))
        before = tiled.launches
        seed21 = ShardedBoard.from_global(
            mesh24, bigboard.seed_packed(size16, bigboard.r_pentomino(size16), device=dev))
        t0 = time.monotonic()
        res21 = eng21.run(Params(turns=1000, image_width=size16, image_height=size16), None,
                          plane=plane21, initial_state=seed21)
        alive21 = res21.alive_count
        walls21[depth] = time.monotonic() - t0
        final21 = eng21.final_state()
        check(type(final21) is ShardedBoard and all(b.is_cuda for b in final21.blocks.values()),
              f"depth {depth}: the mesh state left the card")
        want21 = 8 * sum(exchanges_per_dispatch(b - a, depth)
                         for a, b in zip(gates21, gates21[1:]))
        got21 = tiled.launches - before
        check(res21.turns_completed == 1000 and alive21 == 156,
              f"(2, 4) mesh depth {depth}: alive {alive21} at turn {res21.turns_completed}")
        check(torch.equal(final21.gather(), dense16),
              f"(2, 4) mesh depth {depth}: the board differs from phase 6's single board")
        check(got21 == want21, f"(2, 4) mesh depth {depth}: {got21} tiled launches, "
                               f"want {want21} (8 x the exchanges of chunks {gates21})")
        walls21[depth] = (walls21[depth], got21, len(gates21) - 1)
    soup_launches = {}
    for depth in (1, 3, 8):
        before = tiled.launches
        got = sharded_bit_step_n_fn(mesh24, halo_depth=depth)(
            ShardedBoard.from_global(mesh24, soup21), 100)
        soup_launches[depth] = tiled.launches - before
        check(torch.equal(got.gather(), soup21_want),
              f"4096^2 soup x 100 on the (2, 4) mesh, depth {depth}: differs from "
              "the single-board tiled step_n")
        check(soup_launches[depth] == 8 * exchanges_per_dispatch(100, depth),
              f"4096^2 soup depth {depth}: {soup_launches[depth]} tiled launches")
    got = close_window("the (2, 4) mesh", ("tiled",))
    print(f"phase 21 mesh, packed: 16384^2 R-pentomino x 1000 through Engine.run on "
          f"ShardedBitPlane over a (2, 4) mesh of eight shards on {dev} (the tiled kernel "
          f"equal to its plain version first on haloed blocks of {ext_shapes}): alive 156 "
          f"and the "
          f"board equal to phase 6's single-board result at depth 1 (wall "
          f"{walls21[1][0]:.3f} s, {walls21[1][2]} chunks, {walls21[1][1]} tiled launches) "
          f"and depth 8 ({walls21[8][0]:.3f} s, {walls21[8][2]} chunks, {walls21[8][1]} "
          f"launches), each 8 x the chunks' exchanges; a random 4096^2 soup x 100 at "
          f"depth 1, 3 and 8 equal to the single-board tiled step_n "
          f"({soup_launches[1]}, {soup_launches[3]}, {soup_launches[8]} launches); "
          f"{got['tiled']} tiled launches in all, plain version on the card "
          f"{tiled.plain_calls} times {card_tag}")
    check(tiled.plain_calls == 0, "the mesh phases ran the tiled kernel's plain version")

    # 21b. the byte mesh plane (parallel/halo.py, torch ops as the JAX
    # package's XLA): 512^2 x {0, 1, 100} through run() with the (2, 4)
    # mesh as the engine's step function, PGMs against check/images
    open_window()
    for turns in (0, 1, 100):
        params = Params(turns=turns, image_width=512, image_height=512)
        run(params, images_dir=REPO / "images", out_dir=out_dir, tick_seconds=3600,
            engine_config=EngineConfig(step_n_fn=make_engine_step(mesh24)))
        name = f"512x512x{turns}.pgm"
        check((out_dir / name).read_bytes() == (REPO / "check" / "images" / name).read_bytes(),
              f"byte mesh session {name}: PGM bytes differ from check/images")
    close_window("the byte mesh plane", ())
    print(f"phase 21b mesh, bytes: 512^2 x {{0, 1, 100}} through run() with "
          f"make_engine_step on the (2, 4) mesh: PGMs equal check/images {card_tag}")

    # 22. the pod: `python -m gol_distributed_final_tpu_torch.pod -size
    # 16384 -turns 1000` in a child process that has joined a one-rank
    # NCCL group (every gate's control word is an NCCL broadcast), its
    # PGM read back packed against phase 6's board; a run stopped at turn
    # 500 with -ck -ck-every 500, resumed with -resume in a fresh process
    # to 1000, gives the same PGM. The children's tiled launches join the
    # main path's count.
    pod_dir = out_dir / "pod"
    ck22 = pod_dir / "podck.npz"
    pod_runs = [
        [["-size", "16384", "-turns", "1000", "-out", str(pod_dir / "full")],
         ["-size", "16384", "-turns", "500", "-out", str(pod_dir / "stop"), "-ck", str(ck22),
          "-ck-every", "500"]],
        [["-size", "16384", "-turns", "1000", "-out", str(pod_dir / "resumed"), "-ck",
          str(ck22), "-resume"]],
    ]
    pod_out = [pod_child(runs) for runs in pod_runs]
    pod_launches = sum(int(re.search(r"POD_LAUNCHES tiled=(\d+)", o).group(1)) for o in pod_out)
    pod_plain = sum(int(re.search(r"plain=(\d+)", o).group(1)) for o in pod_out)
    launches["tiled"] += pod_launches
    plain["tiled"] += pod_plain
    check(pod_out[0].count("alive 156\n") == 1 and "alive 156\n" in pod_out[1],
          f"pod runs: {pod_out}")
    check("NCCL collectives ok" in pod_out[0], "the pod child's NCCL collectives")
    full22 = pod_dir / "full" / "16384x16384x1000.pgm"
    check(torch.equal(bigboard.load_packed_from_pgm(full22), dense16),
          "pod 16384^2 x 1000: its PGM differs from phase 6's single-board state")
    with np.load(ck22, allow_pickle=False) as data:
        ck22_turn = int(data["turn"])
    check(ck22_turn == 500, f"pod checkpoint at turn {ck22_turn}, want 500")
    resumed22 = pod_dir / "resumed" / "16384x16384x1000.pgm"
    check(filecmp.cmp(full22, resumed22, shallow=False),
          "pod resumed from turn 500: its PGM differs from the uninterrupted run's")
    shutil.rmtree(pod_dir)
    print(f"phase 22 pod: python -m gol_distributed_final_tpu_torch.pod -size 16384 -turns "
          f"1000 in a one-rank NCCL group: alive 156, its PGM read back packed equals phase "
          f"6's board; stopped at turn 500 (-ck -ck-every 500) and resumed with -resume in a "
          f"fresh process: the same PGM; {pod_launches} tiled launches in the children "
          f"(plain {pod_plain}) {card_tag}")

    # 23. observability on the card: the layer's own path, its launches
    # counted in its windows like every path's
    observability(dev, board512, golden_counts, card_tag, open_window, close_window,
                  controller_main)

    # 24. the operator tools against the port's roles on the card: the
    # canary's two verbs, loadgen, the fleet, doctor, watch, history,
    # flame, regress, an injected wrong board and the static analysis
    tools(dev, card_tag, open_window, close_window)

    # 25 and 26: the per-turn alive history and the session soak, each in a
    # window of its own whose launches stay out of the main path's counts
    def side_window_close(label, expect):
        got = {name: module.launches for name, module in counted.items()}
        for name in expect:
            check(got[name] > 0, f"{label}: the {name} kernel never launched")
        check(not any(module.plain_calls for module in counted.values()),
              f"{label}: a plain version ran on the card")
        return got

    history_row = alive(dev, card_tag, open_window, side_window_close)
    session_soak_phase(dev, SOAK_SECONDS, card_tag, open_window, side_window_close)

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
    # both routes of a single board, counted, at the engine's chunk and at
    # 100 turns
    for side in (512, 256, 128):
        packed = bitpack.pack(board512[:side, :side], 0, dev)
        plan = whole_board.cluster_plan(tuple(packed.shape))
        out = torch.empty_like(packed)
        counts = torch.empty(packed.shape[0], dtype=torch.int32, device=dev)
        for n, reps in ((100, 50), (4096, 5)):
            picked = cuda_ms(lambda: whole_board.step_n(packed, n, counted=True), reps=reps)
            block = cuda_ms(lambda: whole_board.launch_one(
                packed, out, counts, n, 0, CONWAY.birth_mask, CONWAY.survive_mask,
                "pallas.vmem_bit", whole_board.Route(1)), reps=reps)
            print(f"timing whole-board {side}^2 n={n}: {picked:.5f} ms on the route picked "
                  f"({plan}), {block:.5f} ms on one block, "
                  f"{block / picked:.3g}x {card_tag}")

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

    # the (2, 4) mesh plane on one card at 16384^2 (phase 21's board at
    # turn 1000): device time per 64-turn dispatch at depth 1 and 8 against
    # the single-board tiled step_n of the same 64 turns, from one trace of
    # each (every kernel's duration; the fullest of up to six traces that
    # hold the dispatch's tiled launches), split into the tiled kernel and
    # the rest, which is the ext build and the halo copies; and events
    # around each dispatch (host work included)
    def mesh_split(fn, tiled_launches):
        """``(tiled ms, rest ms, rest records, rest launches)`` of one
        ``fn()``: the first of up to eight traces that holds every tiled
        launch and a device record for each of its other launch calls;
        else the fullest, and a line says how many records it lacks."""
        fn()
        best = None
        for _ in range(8):
            prof = trace(fn)
            calls = launch_calls(prof)
            records = window_records(prof, r".")
            kern = [end - start for name, start, end in records if "tiled_kernel" in name]
            rest = [end - start for name, start, end in records if "tiled_kernel" not in name]
            if len(kern) == tiled_launches and len(kern) + len(rest) == calls:
                return sum(kern) / 1e3, sum(rest) / 1e3, len(rest), calls - tiled_launches
            if best is None or len(kern) + len(rest) > len(best[0]) + len(best[1]):
                best = (kern, rest, calls)
        kern, rest, calls = best
        print(f"  mesh_split: no trace held all {tiled_launches} tiled launches and "
              f"{calls - tiled_launches} other records; the fullest held {len(kern)} and "
              f"{len(rest)}, so its share lacks {calls - len(kern) - len(rest)} records")
        return sum(kern) / 1e3, sum(rest) / 1e3, len(rest), calls - tiled_launches

    mesh_state = ShardedBoard.from_global(mesh24, dense16)
    mesh_rows = []
    for depth in (1, 8):
        step64 = sharded_bit_step_n_fn(mesh24, halo_depth=depth)
        kern_ms, rest_ms, rest_n, rest_want = mesh_split(
            lambda: step64(mesh_state, 64), 8 * exchanges_per_dispatch(64, depth))
        ev_ms = cuda_ms(lambda: step64(mesh_state, 64), reps=5)
        mesh_rows.append((depth, kern_ms, rest_ms, rest_n, rest_want, ev_ms))
    # the single board's 8 launches: device_ms's window of several calls,
    # which a trace that loses a few records still serves
    single_dev = 8 * device_ms(lambda: tiled.step_n(dense16, 64), "tiled_kernel", reps=5,
                               per_call=8)[0]
    single_ev = cuda_ms(lambda: tiled.step_n(dense16, 64), reps=5)
    print(f"timing mesh 16384^2, one 64-turn dispatch (device ms from the trace: tiled kernel "
          f"+ ext build and halo copies = total, their share; events ms): "
          + "; ".join(f"(2, 4) depth {d}: {k:.4f} + {r:.4f} ({n} of {w} copy kernels) = "
                      f"{k + r:.4f}, {100 * r / (k + r):.1f}% ext and halos; events {e:.3f}"
                      for d, k, r, n, w, e in mesh_rows)
          + f"; single board, tiled step_n: {single_dev:.4f} (8 launches), events "
          f"{single_ev:.3f} {card_tag}")
    del mesh_state

    # the activity-sparse kernel: a dispatch of 64 8-turn blocks, one
    # cooperative launch, on the R-pentomino after 1000 turns at 16384^2
    # and 65536^2: the device span per block (the launch's first sparse
    # kernel's start to its last one's end, over the blocks), the sum of the
    # traced kernels' durations, and events per block over the dispatch
    # (the board's copy included); the bound counts the active tiles' words
    # at ops_per_word x 8 against the windows read and the tiles written a
    # block, and the grid read and written once a dispatch
    sparse_kernels = SPARSE_KERNELS

    def sparse_bound(tile, h_turns, tiles_per_block, grid_tiles, blocks):
        tr, tc = tile
        t_ops = tiles_per_block * tr * tc * opw * h_turns / int32_rate
        t_bytes = (tiles_per_block * ((tr + 2) * (tc + 2 * h_turns) + tr * tc) * 4
                   + 2 * grid_tiles / blocks) / HBM_BYTES_PER_S
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")

    def sparse_block_times(st, blocks=64):
        tile = sparse.sparse_tile_shape(tuple(st.packed.shape))
        total = (st.packed.shape[0] // tile[0]) * (st.packed.shape[1] // tile[1])
        cap = min(sparse._pow2_ceil(max(st.count, 8) * 4), sparse._pow2_ceil(total))

        def call():
            return sparse_tiles.dispatch(st.packed, st.grid, blocks, tile, 8, cap, 8, 12)

        run_ = call()
        check(run_.blocks_done == blocks, f"the timed dispatch stopped at {run_.blocks_done}")
        torch.cuda.synchronize()
        sparse_tiles.reset_counts()
        call()
        check(sparse_tiles.launches == 1, f"a dispatch made {sparse_tiles.launches} launches")
        events_ms = cuda_ms(call, reps=5, warmup=1) / blocks
        launch_ms, _ = sparse_launch_ms(st, tile, 8, cap, blocks)
        span, spans = device_span_ms(call, sparse_kernels, 1, fallback=lambda: float("nan"))
        b_ms, b_by = sparse_bound(tile, 8, run_.active_sum / blocks, total, blocks)
        ctas = sparse_tiles.ctas(tile, 8, cap, 8, 12)
        return (events_ms, launch_ms / blocks, span / blocks, b_ms, b_by,
                run_.active_sum / blocks, spans, tile, cap, ctas)

    sparse_times = {}
    for label, st in (("16384^2", sparse16), ("65536^2", sparse65)):
        ev, dv, traced, b_ms, b_by, per_block, spans, tile, cap, ctas = sparse_block_times(st)
        sparse_times[label] = (ev, dv, b_ms, b_by, tile, cap)
        print(f"timing sparse {label} R-pentomino after 1000 turns: {dv:.5f} ms per 8-turn block "
              f"by events around the launch alone (one launch of 64 blocks on {ctas} CTAs, "
              f"capacity {cap}); the profiler's device span {traced:.5f} ms a block (least of "
              f"{spans} complete traces; nan: none held the launch); events {ev:.5f} ms per "
              f"block over the wrapper's dispatch, the board's copy and the readback included; "
              f"{per_block:.1f} active tiles of {tile[0]} x {tile[1]} words a block, bound "
              f"{b_ms:.6f} ms ({b_by}), {dv / b_ms:.3g}x the bound {card_tag}")
    ev16, dv16, b16, by16, tile16, cap16 = sparse_times["16384^2"]
    sparse_plain_ms = cuda_ms(lambda: sparse_tiles.dispatch_plain(
        sparse16.packed, sparse16.grid, 8, tile16, 8, cap16, 8, 12), reps=1, warmup=1) / 8
    print(f"timing sparse plain program on the card at 16384^2 (torch ops, a measurement: "
          f"it is not on the path): {sparse_plain_ms:.3f} ms per 8-turn block {card_tag}")

    # where the 65536^2 R-pentomino x 1000 on the sparse plane spends its
    # wall: each dispatch's copy of the board it writes into (its input is
    # never written), the sparse kernel (the traced launches' durations),
    # each dispatch's readback of its counts, and the period-2 probe's
    # whole-board comparisons (its two one-turn dispatches are dispatches
    # like the others); the rest is host work
    real_dispatch, dispatched = sparse_tiles.dispatch, []

    def counting_dispatch(*args):
        dispatched.append(args[4])  # h: the probe's dispatches are h = 1
        return real_dispatch(*args)

    seed65 = bigboard.seed_packed(size65, bigboard.r_pentomino(size65))

    def run65():
        return plane65.step_n(plane65.from_packed(seed65), 1000)

    sparse_tiles.dispatch = counting_dispatch
    try:
        wall65, _ = timed_wall(run65)
    finally:
        sparse_tiles.dispatch = real_dispatch
    run65()
    # the sparse launches' durations, from a trace that holds all of them
    kernel65 = None
    for _ in range(8):
        records = window_kernels(trace(run65), rf"::(?:{sparse_kernels})[<(]")
        if len(records) == len(dispatched):
            kernel65 = sum(us for _, us in records) / 1e3
            break
    copy65 = cuda_ms(lambda: sparse65.packed.clone(), reps=10)
    twin65 = sparse65.packed.clone()
    equal65 = cuda_ms(lambda: torch.equal(sparse65.packed, twin65), reps=10)
    counts65 = torch.zeros(65, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        counts65.cpu().tolist()
    readback65 = (time.perf_counter() - t0) * 10  # ms each
    # a probe is two one-turn dispatches and at most two comparisons
    one_turn65 = dispatched.count(1)
    parts65 = {"board copies": len(dispatched) * copy65, "sparse kernel": kernel65,
               "readbacks": len(dispatched) * readback65,
               "probe comparisons (at most)": one_turn65 * equal65}
    if kernel65 is None:
        print(f"  no trace of the 65536^2 run held its {len(dispatched)} sparse launches")
        parts65["sparse kernel"] = 0.0
    rest65 = wall65 * 1e3 - sum(parts65.values())
    print(f"timing sparse 65536^2 R-pentomino x 1000 on the plane: wall {wall65 * 1e3:.3f} ms, "
          f"{len(dispatched)} dispatches ({one_turn65} of one turn: the period-2 probe's and "
          f"any tail); a board copy {copy65:.4f} ms, a readback {readback65:.4f} ms, a "
          f"whole-board comparison {equal65:.4f} ms: "
          + ", ".join(f"{name} {ms:.3f} ms ({100 * ms / (wall65 * 1e3):.1f}%)"
                      for name, ms in parts65.items())
          + f", the rest (host) {rest65:.3f} ms {card_tag}")
    del seed65, twin65

    # sparse against dense: the R-pentomino x 1000 through each plane (wall
    # with a synchronise, and device time) from 1024^2 to 65536^2, which is
    # where SPARSE_MIN_CELLS stands (``sparse_against_dense``, which
    # --sparse-dense repeats at 4096^2 and 8192^2 with soups); then one
    # 8-turn block of the sparse kernel against one 8-turn launch of the
    # tiled kernel on soups with 5%, 25%, 50% and 100% of the tiles active
    # (capacity for every tile, so no overflow), which is where the density
    # crossover stands, and the two planes' walls for 64 turns of the 5% and
    # 25% soups
    print("sparse against dense, the R-pentomino x 1000 (wall s / device ms; sparse "
          "from_packed included):")
    sparse_against_dense(dev, card_tag, (1024, 2048, 4096, 8192, 16384, 65536), device_time=True)
    print("sparse against dense, one 8-turn block of the sparse kernel against one 8-turn "
          "tiled launch (device ms / events ms), and 64 turns through each plane (wall s):")
    for side in (4096, 16384, 65536):
        shape = bitpack.packed_shape(side, side)
        tile = sparse.sparse_tile_shape(shape)
        total = (shape[0] // tile[0]) * (shape[1] // tile[1])
        for frac in (0.05, 0.25, 0.5, 1.0):
            packed = make_tile_soup(shape, tile, frac, side + int(frac * 1000), dev)
            grid = sparse.occupancy_grid(packed, *tile)
            count = int(grid.sum())
            cap = sparse._pow2_ceil(total)

            def one_block():
                return sparse_tiles.dispatch(packed, grid, 1, tile, 8, cap, 8, 12)

            s_dev = device_ms(one_block, sparse_kernels, reps=5)[0]
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
          "sparse_tiles ms = one 8-turn block, the time of a 64-block dispatch's one "
          "cooperative launch by events around it over its blocks, on the 16384^2 "
          "R-pentomino after 1000 turns, its plain_ms the plain program's block on the card; "
          "strip_steps ms = one 8-turn launch on a 1040x4096 "
          "block with its bands, dirty grid and digest sums (20b's batch, device time); "
          "library_ms "
          "null: no single PyTorch call computes a life-like turn")
    print(json.dumps({"history": history_row}))
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
    if sys.argv[1:2] == ["--k1-sweep"]:
        sys.exit(k1_sweep())
    if sys.argv[1:2] == ["--workers-times"]:
        sys.exit(workers_times(sys.argv[2] if len(sys.argv) > 2 else str(REPO)))
    if sys.argv[1:2] == ["--sparse-sweep"]:
        sys.exit(sparse_sweep(sys.argv[2] if len(sys.argv) > 2 else str(REPO / "build" / "sweep")))
    if sys.argv[1:2] == ["--sparse-dense"]:
        sys.exit(sparse_dense())
    if sys.argv[1:2] == ["--pod-layouts"]:
        sys.exit(pod_layouts())
    if sys.argv[1:2] == ["--observability"]:
        sys.exit(observability_only())
    if sys.argv[1:2] == ["--tools"]:
        sys.exit(tools_only())
    if sys.argv[1:2] == ["--alive"]:
        sys.exit(alive_only())
    if sys.argv[1:2] == ["--soak"]:
        sys.exit(soak_only(float(sys.argv[2]) if len(sys.argv) > 2 else SOAK_SECONDS))
    if sys.argv[1:2] == ["--sparse-times"]:
        sys.exit(sparse_times(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else sys.argv[2]))
    sys.exit(main())
