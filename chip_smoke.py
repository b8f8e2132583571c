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
run the byte kernels), and times the kernels with CUDA events. The bitboard
kernels compile the four named rules in; the parity phases also run a rule
outside them (B36/S125) and check, by the kernels' names in the profiler's
trace, that it ran the run-time-rule instantiation. Any failed check
raises, so the exit code is non-zero and the closing JSON line is never
printed. Without a CUDA device, or without the package beside it, it
exits non-zero before printing any result.

    python3 chip_smoke.py --kernel-times [TREE]

times only K1, K2 and the tiled kernel of the port in the checkout TREE
(default: this one) and prints one JSON line, so that two trees can be
compared in turns within one call on one card.

Game of Life is integer-exact: every comparison is equality (tolerance 0).
"""

from __future__ import annotations

import csv
import gc
import json
import os
import pathlib
import queue
import re
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


def device_ms(fn, kernel: str, reps: int) -> tuple[float, int]:
    """``(ms, launches)``: the mean device time of one launch of the CUDA kernel named ``kernel``,
    from torch.profiler's trace of ``reps`` calls of ``fn()`` after a
    warm-up: the kernel's own time. CUDA events around back-to-back calls
    measure the host's launch rate instead once a kernel is shorter than
    its wrapper's host work. The mean is over the launches the trace
    holds, which may be fewer than the calls; their number comes back
    with it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace can come back without the card's activity (seen once on the
    # H100 in a run whose other traces held theirs): take a fresh one then
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, traced = 0.0, 0
        for ev in prof.key_averages():
            if re.search(rf"::{kernel}[<(]", ev.key):
                total_us += getattr(ev, "device_time_total", 0) or ev.cuda_time_total
                traced += ev.count
        if traced > 0 and total_us > 0:
            if attempt:
                print(f"  device_ms: the trace of {kernel} held its launches at attempt "
                      f"{attempt + 1}")
            return total_us / traced / 1e3, traced
    raise RuntimeError(f"check failed: the profiler saw no launch of {kernel} in 3 traces")


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def kernel_label(mangled: str) -> str:
    """A kernel instantiation's short name from its mangled one, e.g.
    ``tiled<0, 8, StaticRule<8, 0, 16>>``."""
    kernel = re.search(r"(whole_board|tiled|byte_board|byte_tiled)_kernel", mangled)
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


def kernel_times(tree: str) -> int:
    """Time K1, K2 and the tiled kernel of the port in ``tree`` (a checkout's
    root) at the smoke's shapes, and print them as one JSON line: the
    parent-and-change comparison, run in turns within one call."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from gol_distributed_final_tpu_torch.ops import batch_board, tiled, whole_board

    check(pathlib.Path(whole_board.__file__).is_relative_to(pathlib.Path(tree).resolve()),
          f"the port imported from {tree}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def words(shape):
        return torch.from_numpy(
            rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
        ).to(dev)

    p512, b1000, b256 = words((16, 512)), words((1000, 4, 128)), words((256, 4, 128))
    t16k, t4k = words((512, 16384)), words((128, 4096))
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
    from gol_distributed_final_tpu_torch.engine import Engine, EngineConfig
    from gol_distributed_final_tpu_torch.engine.controller import CLOSED
    from gol_distributed_final_tpu_torch.io.pgm import read_pgm
    from gol_distributed_final_tpu_torch.models import (
        CONWAY, DAY_AND_NIGHT, HIGHLIFE, SEEDS, LifeRule,
    )
    from gol_distributed_final_tpu_torch.__main__ import main as controller_main
    from gol_distributed_final_tpu_torch.engine.sessions import SessionTable
    from gol_distributed_final_tpu_torch.ops import (
        _build, batch_board, bitpack, byte_board, byte_tiled, tiled, whole_board,
    )
    from gol_distributed_final_tpu_torch.ops.auto import auto_batch_plane, auto_plane
    from gol_distributed_final_tpu_torch.ops.batched import BatchBitPlane
    from gol_distributed_final_tpu_torch.ops.fused import FusedBitPlane, fused_step_n
    from gol_distributed_final_tpu_torch.ops.pallas_stencil import pallas_step_n_fn
    from gol_distributed_final_tpu_torch.ops.plane import BitPlane
    from gol_distributed_final_tpu_torch.rpc import broker
    from gol_distributed_final_tpu_torch.rpc.client import RemoteBroker, RpcError

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
    for name, want in (("whole_board", ("whole_board_kernelILi0E", "StaticRuleILj8ELj0ELj16E")),
                       ("tiled", ("tiled_kernelILi0ELi8E", "StaticRuleILj8ELj0ELj16E"))):
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
    print(f"phase 3 parity: tiled kernel equals its plain version and the "
          f"whole-torus bit_step_n in {tiled_cases} cases (4096^2 both packings, "
          f"1024x16384, 16384^2, and packed 45x300 / 300x45 with ragged tiles; "
          f"Conway and B36/S125, k in 1/3/8, n=13)")

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
    from torch.profiler import ProfilerActivity, profile

    for rule, kind in ((CONWAY, "StaticRule<8u, 0u, 16u>"), (other, "DynamicRule")):
        masks = (rule.birth_mask, rule.survive_mask)
        p64 = random_words((3, 2, 64))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            whole_board.step_n(p64[0], 3, 0, *masks)
            batch_board.step_n(p64, 3, 0, *masks)
            tiled.step_n(p64[0], 3, 0, *masks)
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages()
                 if re.search(r"::(whole_board|tiled)_kernel<", ev.key)]
        launched = sum(ev.count for ev in prof.key_averages() if ev.key in names)
        check(launched == 3 and all(kind in name for name in names),
              f"{rule.name} launched {names}")
        short = sorted({re.sub(r"^void \(anonymous namespace\)::|\(.*$", "", n) for n in names})
        print(f"phase 3 rule: {rule.name} ({rule.rulestring}) ran {'; '.join(short)}")

    def random_bytes(shape):
        return torch.from_numpy(
            np.where(rng.random(shape) < 0.35, 255, 0).astype(np.uint8)
        ).to(dev)

    k5_err = 0
    k5_cases = 0
    # the step-function sessions' boards under the gate (16^2, 64^2), the
    # timed 256^2 and the largest square the gate takes, 340^2
    k5_shapes = ((16, 16), (24, 33), (64, 64), (128, 128), (256, 256), (340, 340))
    check(byte_board.fits((340, 340), dev) and not byte_board.fits((341, 341), dev),
          "340^2 is the largest square under the byte kernel's gate")
    for shape in k5_shapes:
        board = random_bytes(shape)
        for rule in rules:
            for n in (1, 7, 100):
                got = byte_board.step_n(board, n, rule.birth_mask, rule.survive_mask)
                want = byte_board.step_n_plain(board, n, rule.birth_mask, rule.survive_mask)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                check(err == 0, f"byte board {shape} {rule.name} n={n}: max abs err {err}")
                k5_err = max(k5_err, err)
                k5_cases += 1
    print(f"phase 3 parity: whole-board byte kernel equals its plain version in "
          f"{k5_cases} cases (16^2, 24x33, 64^2, 128^2, 256^2, 340^2; 4 rules, n in "
          f"1/7/100)")

    k6_err = 0
    k6_cases = 0
    # the JAX package's test shape, the 512^2 sessions' board, a wide board
    for shape in ((64, 128), (512, 512), (4096, 4096)):
        board = random_bytes(shape)
        for rule in rules:
            for k in (1, 8, 32):
                args = (board, k, rule.birth_mask, rule.survive_mask)
                got = byte_tiled.step_n(*args, turns_per_launch=k)
                want = byte_tiled.step_n_plain(*args, turns_per_launch=k)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                check(err == 0, f"byte tiles {shape} {rule.name} k={k}: max abs err {err}")
                k6_err = max(k6_err, err)
                k6_cases += 1
    print(f"phase 3 parity: byte-tile kernel equals its plain version in {k6_cases} "
          f"cases (64x128, 512^2, 4096^2; 4 rules, one launch of 1/8/32 turns)")

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

    # 5b. the same counts through the byte tiles: fused_step_n(board, 1) as
    # the engine's step function, one turn per chunk, and the board after
    # fused_step_n(board, 10000) (the K = 8 ladder) against the one reached
    # one turn at a time. Checks of their own, out of the main path's counts.
    seen.clear()
    engine = Engine(EngineConfig(max_chunk=1, chunk_hook=record, step_n_fn=fused_step_n))
    before = byte_tiled.launches
    stepwise = engine.run(Params(turns=10_000, image_width=512, image_height=512), board512)
    per_turn_launches = byte_tiled.launches - before
    bad = [t for t in range(1, 10_001) if seen.get(t) != golden_counts[t]]
    check(not bad, f"512^2 alive counts through fused_step_n differ at turns {bad[:5]}")
    check(per_turn_launches == 10_000, f"one byte-tile launch per turn, got {per_turn_launches}")
    before = byte_tiled.launches
    laddered = fused_step_n(torch.from_numpy(board512.copy()).to(dev), 10_000)
    ladder_launches = byte_tiled.launches - before
    check(np.array_equal(laddered.cpu().numpy(), stepwise.world),
          "512^2 after fused_step_n(board, 10000) differs from one turn at a time")
    check(ladder_launches == 1250, f"the K = 8 ladder of 10000 turns: {ladder_launches}")
    print("phase 5b alive: 512^2 per-turn alive counts for turns 1..10000 through "
          "fused_step_n equal check/alive/512x512.csv (10000 one-turn byte-tile launches), "
          "and fused_step_n(board, 10000) in 1250 8-turn launches equals the board "
          "reached one turn at a time (kept out of the main path's counts)")

    # -- the main paths, every launch counted -----------------------------
    # each path runs with every count set to 0 just before it and read just
    # after; launches made to compare a kernel with a reference stay out
    counted = {"whole_board": whole_board, "tiled": tiled, "batch_board": batch_board,
               "byte_board": byte_board, "byte_tiled": byte_tiled}
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

    # 6. real size: an R-pentomino on 16384^2, 1000 turns on the tiled kernel
    size = 16384
    plane = auto_plane(CONWAY, (size, size), dev)
    check(type(plane) is BitPlane, f"16384^2 routes to BitPlane, got {type(plane)}")
    seed = np.zeros(bitpack.packed_shape(size, size, plane.word_axis), np.int32)
    cx = cy = size // 2
    for dx, dy in ((1, 0), (2, 0), (0, 1), (1, 1), (1, 2)):
        x, y = cx + dx, cy + dy
        seed.view(np.uint32)[y // 32, x] |= np.uint32(1 << (y % 32))
    state = bitpack.state_from_numpy(seed, dev)
    torch.cuda.synchronize()
    before = tiled.launches
    t0 = time.monotonic()
    big = Engine(EngineConfig(final_world=False)).run(
        Params(turns=1000, image_width=size, image_height=size), None,
        plane=plane, initial_state=state,
    )
    big_alive = big.alive_count
    big_wall = time.monotonic() - t0
    check(big.turns_completed == 1000, "16384^2 turns")
    check(big_alive == 156, f"16384^2 R-pentomino alive at turn 1000: {big_alive}, want 156")
    print(f"phase 6 real size: 16384^2 R-pentomino x 1000 turns through Engine.run: "
          f"alive 156, wall {big_wall:.3f} s, {tiled.launches - before} tiled "
          f"launches {card_tag}")

    close_window("in-process sessions and the 16384^2 run", ("whole_board", "tiled"))

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
    # through pallas_step_n_fn (K5 under its gate, K6 in launches of 32
    # turns past it) and through fused_step_n (K5's ladder under the gate,
    # K6's past it), PGM bytes against check/images; then the 512^2 x
    # 10000 session through fused_step_n
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
        if turns and size < 512:
            check(k5 > 0 and k6 == 0, f"{fn_name} {size}^2 x {turns}: K5 {k5}, K6 {k6}")
        elif turns:
            check(k6 > 0 and k5 == 0, f"{fn_name} {size}^2 x {turns}: K5 {k5}, K6 {k6}")
        else:
            check(k5 == k6 == 0, f"{fn_name} {size}^2 x {turns}: K5 {k5}, K6 {k6}")
    print("phase 12 step functions: {16,64,512}^2 x {0,1,100} PGMs through "
          "pallas_step_n_fn and fused_step_n equal check/images byte for byte "
          f"({byte_board.launches} whole-board byte launches at 16^2 and 64^2, "
          f"{byte_tiled.launches} byte-tile launches at 512^2)")
    # a host-bound wall: collect the earlier phases' garbage first, so a
    # full collection of it does not land inside this session
    gc.collect()
    before = byte_tiled.launches
    t0 = time.monotonic()
    result = run(Params(turns=10_000, image_width=512, image_height=512),
                 images_dir=REPO / "images", out_dir=out_dir, tick_seconds=3600,
                 engine_config=EngineConfig(step_n_fn=fused_step_n))
    fused_wall = time.monotonic() - t0
    fused_session_launches = byte_tiled.launches - before
    check(result.turns_completed == 10_000 and
          result.alive_count == golden_counts[10_000],
          "512^2 x 10000 session through fused_step_n: final alive count")
    close_window("step-function sessions", ("byte_board", "byte_tiled"))
    print(f"timing session 512^2 x 10000 through fused_step_n: wall {fused_wall:.3f} s, "
          f"{10_000 * 512 * 512 / fused_wall:.4g} cell-updates/s, "
          f"{fused_session_launches} byte-tile launches {card_tag}")

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
    b256 = random_bytes((256, 256))
    k5_ms, k5_traced = device_ms(lambda: byte_board.step_n(b256, 100), "byte_board_kernel",
                                 reps=20)
    k5_events_ms = cuda_ms(lambda: byte_board.step_n(b256, 100), reps=50)
    k5_plain_ms = cuda_ms(lambda: byte_board.step_n_plain(b256, 100), reps=3, warmup=1)
    k5_bound_ms, k5_by = byte_bound(b256.numel(), 100)
    b64 = random_bytes((64, 64))
    k5_small_ms, k5_small_traced = device_ms(lambda: byte_board.step_n(b64, 8),
                                             "byte_board_kernel", reps=50)
    k5_small_events_ms = cuda_ms(lambda: byte_board.step_n(b64, 8), reps=200)
    print(f"timing whole-board byte 256^2: {k5_ms:.4f} ms of device time per n=100 "
          f"launch ({k5_traced} traced; {k5_ms * 1e3 / 100:.3f} us/turn; events "
          f"{k5_events_ms:.4f} ms per call), bound {k5_bound_ms:.5f} ms ({k5_by}), "
          f"{k5_ms / k5_bound_ms:.3g}x the bound; plain {k5_plain_ms:.3f} ms; 64^2 n=8: "
          f"{k5_small_ms:.4f} ms of device time ({k5_small_traced} traced; events "
          f"{k5_small_events_ms:.4f} ms per call) {card_tag}")

    k6_times = {}
    for shape in ((512, 512), (4096, 4096)):
        board = random_bytes(shape)

        def launch8():
            byte_tiled.step_n(board, 8, turns_per_launch=8)

        one_launch, traced = device_ms(launch8, "byte_tiled_kernel", reps=20)
        events_ms = cuda_ms(launch8, reps=20)
        plain_ms = cuda_ms(lambda: byte_tiled.step_n_plain(board, 8, turns_per_launch=8),
                           reps=2, warmup=1)
        b_ms, b_by = byte_bound(board.numel(), 8)
        k6_times[shape] = (one_launch, plain_ms, b_ms, b_by)
        print(f"timing byte tiles {shape[0]}x{shape[1]}: {one_launch:.4f} ms of device "
              f"time per 8-turn launch ({traced} traced; {one_launch * 1e3 / 8:.3f} "
              f"us/turn; events {events_ms:.4f} ms per call), bound {b_ms:.5f} ms ({b_by}), "
              f"{one_launch / b_ms:.3g}x the bound; plain {plain_ms:.3f} ms {card_tag}")

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
            "ms": k6_times[512, 512][0],
            "plain_ms": k6_times[512, 512][1],
            "bound_ms": k6_times[512, 512][2],
            "bound_by": k6_times[512, 512][3],
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
          "launch of 100 turns at 256^2; byte_tiled ms = one 8-turn launch at 512^2 "
          "(the profiler's device time); library_ms "
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
    sys.exit(main())
