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
references, and times the kernels with CUDA events. Any failed check
raises, so the exit code is non-zero and the closing JSON line is never
printed. Without a CUDA device, or without the package beside it, it
exits non-zero before printing any result.

Game of Life is integer-exact: every comparison is equality (tolerance 0).
"""

from __future__ import annotations

import csv
import json
import os
import pathlib
import queue
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


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


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
        CONWAY, DAY_AND_NIGHT, HIGHLIFE, SEEDS,
    )
    from gol_distributed_final_tpu_torch.__main__ import main as controller_main
    from gol_distributed_final_tpu_torch.engine.sessions import SessionTable
    from gol_distributed_final_tpu_torch.ops import (
        _build, batch_board, bitpack, tiled, whole_board,
    )
    from gol_distributed_final_tpu_torch.ops.auto import auto_batch_plane, auto_plane
    from gol_distributed_final_tpu_torch.ops.batched import BatchBitPlane
    from gol_distributed_final_tpu_torch.ops.fused import FusedBitPlane
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
    for name, report in sorted(reports.items()):
        for line in report.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in _build.SOURCES:
        check(_build.library_path(name).exists(), f"{name} library built")

    # -- 3. each kernel against its plain version -------------------------
    def random_words(shape):
        return torch.from_numpy(
            rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
        ).to(dev)

    rules = (CONWAY, HIGHLIFE, SEEDS, DAY_AND_NIGHT)
    k1_err = 0
    k1_cases = 0
    # the sessions' boards: 64^2 and 512^2
    for size in (64, 512):
        board = np.where(rng.random((size, size)) < 0.35, 255, 0).astype(np.uint8)
        for word_axis in (0, 1):
            packed = bitpack.pack(board, word_axis, dev)
            for rule in rules:
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
          f"{k1_cases} cases (64^2 and 512^2, 4 rules, n in 1/7/100, both "
          f"packings, counts)")

    tiled_err = 0
    tiled_cases = 0
    # 4096^2 in both packings, 1024x16384, and the real-size board of phase 6
    for shape, word_axis in (((128, 4096), 0), ((4096, 128), 1), ((32, 16384), 0),
                             ((512, 16384), 0), ((45, 300), 0), ((300, 45), 1)):
        packed = random_words(shape)
        whole = bitpack.bit_step_n(packed, 13, word_axis)
        for k in (1, 3, 8):
            got = tiled.step_n(packed, 13, word_axis, turns_per_launch=k)
            want = tiled.step_n_plain(packed, 13, word_axis, turns_per_launch=k)
            torch.cuda.synchronize()
            err = max(max_abs_err(got, want), max_abs_err(got, whole))
            check(err == 0, f"tiled {shape} word_axis={word_axis} k={k}: max abs err {err}")
            tiled_err = max(tiled_err, err)
            tiled_cases += 1
    print(f"phase 3 parity: tiled kernel equals its plain version and the "
          f"whole-torus bit_step_n in {tiled_cases} cases (4096^2 both packings, "
          f"1024x16384, 16384^2, and packed 45x300 / 300x45 with ragged tiles; "
          f"k in 1/3/8, n=13)")

    k2_err = 0
    k2_cases = 0
    # the batched kernel (K2) at the sessions' sizes: B boards of random
    # words, every universe and its row counts against the plain version;
    # the last is the shape the sessions bench below runs and times
    shapes = [(size, batch) for size in (64, 128, 512) for batch in (1, 7, 300)]
    for size, batch in shapes + [(128, 1000)]:
        for word_axis in (0, 1):
            packed = random_words((batch,) + bitpack.packed_shape(size, size, word_axis))
            for rule in rules:
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
          f"cases (B in 1/7/300 at 64^2, 128^2 and 512^2, and B=1000 at 128^2; "
          f"4 rules, n in 1/7/100, both packings, counts)")

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

    # -- the main paths, every launch counted -----------------------------
    # each path runs with every count set to 0 just before it and read just
    # after; launches made to compare a kernel with a reference stay out
    counted = {"whole_board": whole_board, "tiled": tiled, "batch_board": batch_board}
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

        def watch():
            rb = RemoteBroker(addr)
            try:
                k = 0
                while not all_done.is_set():
                    tag = 1 + (37 * k) % n_sess
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
        watcher = threading.Thread(target=watch)
        watcher.start()
        for t in threads:
            t.join(600)
        sessions_wall = time.monotonic() - t0
        all_done.set()
        watcher.join(60)
        got = close_window("256 SessionRuns", ("batch_board",))
        check(not errors, f"SessionRun failures: {errors[:3]}")
        check(not any(t.is_alive() for t in threads) and not watcher.is_alive(),
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
          f"{k1_bound_ms:.5f} ms ({k1_by}), plain {k1_plain_ms:.3f} ms {card_tag}")

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
        print(f"timing tiled {side}^2: {per_turn * 1e3:.3f} us/turn (n=64, 8 "
              f"launches); {one_launch:.4f} ms per 8-turn launch, bound "
              f"{b_ms:.5f} ms ({b_by}), plain {plain_ms:.3f} ms {card_tag}")

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
    ]
    print("kernels: " + "; ".join(
        f"{k['name']} (replaces {k['replaces']}) launches={k['launches']} "
        f"plain_on_card={plain[k['name']]} parity={'exact' if k['max_abs_err'] == 0 else 'FAIL'}"
        for k in kernels
    ))
    print("units: whole_board ms = one counted launch of 100 turns at 512^2; "
          "tiled ms = one 8-turn launch at 16384^2; batch_board ms = one counted "
          "launch of 100 turns over 1000 x 128^2; library_ms null: no single "
          "PyTorch call computes a life-like turn")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
