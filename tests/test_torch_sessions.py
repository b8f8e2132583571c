"""The PyTorch port's multi-universe session table on the CPU, replaying the
tests/test_sessions.py scenarios on the port's ``SessionTable`` and on the
JAX package's, side by side: the same universes, budgets and calls give
the same per-universe results, progress and events (AliveCellsCount,
TurnComplete, FinalTurnComplete), and both equal a per-universe numpy
oracle. Equality throughout (tolerance 0).
"""

import threading
import time

import numpy as np
import pytest

from gol_distributed_final_tpu_torch.engine.sessions import (
    REJECT_REASONS,
    SessionRejected,
    SessionTable,
)
from gol_distributed_final_tpu_torch.models import CONWAY, HIGHLIFE, LifeRule
from gol_distributed_final_tpu_torch.ops.batched import BatchBitPlane, BatchBytePlane

from oracle import vector_step


def _seq(board, n, rule=CONWAY):
    birth = [c for c in range(9) if rule.birth_mask >> c & 1]
    survive = [c for c in range(9) if rule.survive_mask >> c & 1]
    for _ in range(n):
        board = vector_step(board, birth, survive)
    return board


def _mixed_batch(b=3, h=32, w=32, seed=0):
    rng = np.random.default_rng(seed)
    boards = np.where(rng.random((b, h, w)) < 0.3, 255, 0).astype(np.uint8)
    if b > 1:
        boards[0] = 0
        boards[1] = 0
        for y, x in ((1, 2), (2, 3), (3, 1), (3, 2), (3, 3)):
            boards[1, y, x] = 255
    return boards


def _port_table(rule, shape, capacity, **kw):
    return SessionTable(rule, shape, capacity, device="cpu", **kw)


def _jax_table(rule, shape, capacity, **kw):
    from gol_distributed_final_tpu.engine.sessions import SessionTable as JaxTable
    from gol_distributed_final_tpu.models import LifeRule as JaxRule

    return JaxTable(JaxRule.from_rulestring(rule.rulestring), shape, capacity, **kw)


def _event(e):
    alive = getattr(e, "alive", None)
    return (
        type(e).__name__,
        e.completed_turns,
        getattr(e, "cells_count", None),
        None if alive is None else sorted((c.x, c.y) for c in alive),
    )


def _record(sessions, events):
    return {
        "turns": [s.turns_done for s in sessions],
        "alive": [s.alive_count for s in sessions],
        "results": [None if s.result is None else s.result.tolist() for s in sessions],
        "done": [s.done.is_set() for s in sessions],
        "events": {i: [_event(e) for e in evs] for i, evs in events.items()},
    }


def _both(scenario):
    """Run ``scenario(make_table)`` on the port's table and the JAX
    package's; assert the records are equal and return the port's."""
    mine = scenario(_port_table)
    theirs = scenario(_jax_table)
    assert mine == theirs
    return mine


def _drive(table, limit=50):
    n = 0
    while table.advance():
        n += 1
        assert n < limit
    return n


# -- admission control -------------------------------------------------------


def test_admission_refusals_match_jax():
    boards = _mixed_batch(b=3, seed=4)

    def scenario(make):
        table = make(CONWAY, (32, 32), 2)
        table.admit(boards[0], 5)
        table.admit(boards[1], 5)
        reasons = []
        for board, turns in ((boards[2], 5), (np.zeros((16, 16), np.uint8), 5),
                             (boards[0], 0)):
            try:
                table.admit(board, turns)
            except RuntimeError as exc:  # SessionRejected in both packages
                reasons.append((type(exc).__name__, exc.reason))
        return reasons, table.occupancy

    reasons, occupancy = scenario(_port_table)
    assert (reasons, occupancy) == scenario(_jax_table)
    assert [r for _, r in reasons] == ["capacity", "geometry", "turns"]
    assert occupancy == 2
    assert REJECT_REASONS == ("capacity", "geometry", "rule", "turns", "tag")


def test_scheduler_refuses_rule_and_tag_like_jax():
    """The scheduler-level refusals: a second rule while the batch is
    occupied, and a tag already in use."""
    from gol_distributed_final_tpu.rpc.broker import SessionScheduler as JaxScheduler
    from gol_distributed_final_tpu.rpc.protocol import Request as JaxRequest
    from gol_distributed_final_tpu_torch.rpc.broker import SessionScheduler
    from gol_distributed_final_tpu_torch.rpc.protocol import Request

    board = _mixed_batch(b=1, seed=12)[0]
    reasons = {}
    for name, sched, req_cls, make in (
        ("port", SessionScheduler(4, device="cpu"), Request, _port_table),
        ("jax", JaxScheduler(4), JaxRequest, _jax_table),
    ):
        with sched._work:
            sched._table = make(CONWAY, (32, 32), 4)
            sched._table.admit(board, 50)  # occupied: rule and geometry pinned
            sched._tags[9] = object()
        got = []
        for kw in ({"rulestring": "B36/S23"}, {"session_id": 9}):
            req = req_cls(world=board, turns=5, image_height=32, image_width=32, **kw)
            with pytest.raises(RuntimeError) as exc:
                sched.submit(req)
            got.append(exc.value.reason)
        reasons[name] = got
    assert reasons["port"] == reasons["jax"] == ["rule", "tag"]


def test_capacity_and_chunk_bounds_are_checked():
    with pytest.raises(ValueError, match="capacity"):
        _port_table(CONWAY, (32, 32), 0)
    with pytest.raises(ValueError, match="max_chunk"):
        _port_table(CONWAY, (32, 32), 1, max_chunk=0)
    with pytest.raises(SessionRejected):
        _port_table(CONWAY, (32, 32), 1).admit(np.zeros((32, 32), np.uint8), -3)


# -- lifecycle ---------------------------------------------------------------


def test_mid_batch_leave_and_dead_universe_retire_match_jax():
    """Budgets 5 (all dead), 4 and 9: the 4-turn universe and the dead one
    leave at the first boundary, the batch compacts to one slot, the
    survivor finishes bit-identical to its sequential run."""
    boards = _mixed_batch(b=3, seed=5)

    def scenario(make):
        table = make(CONWAY, (32, 32), 4)
        sessions = [table.admit(boards[i], t) for i, t in enumerate((5, 4, 9))]
        remaining = table.advance()
        first = (remaining, len(table._active), int(table._state.shape[0]),
                 [s.done.is_set() for s in sessions])
        _drive(table)
        return first, _record(sessions, {})

    first, rec = _both(scenario)
    assert first == (1, 1, 1, [True, True, False])
    assert rec["turns"] == [5, 4, 9]
    for i, t in enumerate((5, 4, 9)):
        assert np.array_equal(np.array(rec["results"][i], np.uint8), _seq(boards[i], t))


def test_cancel_is_a_mid_batch_leave_like_jax():
    boards = _mixed_batch(b=2, seed=6)

    def scenario(make):
        table = make(CONWAY, (32, 32), 2, max_chunk=2)
        s_a, s_b = table.admit(boards[0], 8), table.admit(boards[1], 8)
        table.advance()  # both at turn 2
        table.cancel(s_b)
        _drive(table)
        return _record([s_a, s_b], {})

    rec = _both(scenario)
    assert rec["done"] == [True, True] and rec["results"][1] is None
    assert rec["turns"][0] == 8


@pytest.mark.parametrize("rule", [CONWAY, HIGHLIFE], ids=lambda r: r.name)
def test_per_session_event_demux_matches_jax(rule):
    """Every event a session sees demuxes from the batched counts: the
    chunk boundaries (power-of-two quantised), the counts and the final
    cells equal the JAX table's and the oracle's."""
    boards = _mixed_batch(b=3, seed=7)
    budgets = (5, 3, 9)

    def scenario(make):
        events = {0: [], 1: [], 2: []}
        table = make(rule, (32, 32), 3)
        sessions = [table.admit(boards[i], t, on_event=events[i].append)
                    for i, t in enumerate(budgets)]
        _drive(table)
        return _record(sessions, events)

    rec = _both(scenario)
    if rule is CONWAY:  # test_sessions.py's boundaries, dead universe included
        ticks = {i: [e[1] for e in rec["events"][i] if e[0] == "AliveCellsCount"]
                 for i in range(3)}
        assert ticks == {0: [2], 1: [2, 3], 2: [2, 3, 7, 9]}
    for i, budget in enumerate(budgets):
        evs = rec["events"][i]
        for name, turn, count, _ in evs:
            if name == "AliveCellsCount":
                assert count == int(np.count_nonzero(_seq(boards[i], turn, rule)))
        final = [e for e in evs if e[0] == "FinalTurnComplete"]
        assert len(final) == 1 and final[0][1] == budget
        ys, xs = np.nonzero(_seq(boards[i], budget, rule))
        assert final[0][3] == sorted(zip(xs.tolist(), ys.tolist()))


def test_snapshot_consistent_mid_drain_like_jax():
    boards = _mixed_batch(b=2, seed=8)

    def scenario(make):
        table = make(CONWAY, (32, 32), 2)
        s_a, s_b = table.admit(boards[0], 4), table.admit(boards[1], 8)
        snaps = [table.snapshot(s_b, include_world=True)]  # pending: the seed
        table.advance()  # k = 4: s_a retires, s_b at turn 4
        snaps.append(table.snapshot(s_b, include_world=True))
        snaps.append(table.snapshot(s_a, include_world=True))  # finished
        snaps.append(table.snapshot(s_b))  # count-only
        return [(None if w is None else w.tolist(), t, a) for w, t, a in snaps]

    snaps = _both(scenario)
    assert snaps[0][1] == 0 and np.array_equal(np.array(snaps[0][0]), boards[1])
    assert snaps[1][1] == 4 and np.array_equal(np.array(snaps[1][0]), _seq(boards[1], 4))
    assert snaps[1][2] == int(np.count_nonzero(_seq(boards[1], 4)))
    assert snaps[2][1] == 4 and np.array_equal(np.array(snaps[2][0]), _seq(boards[0], 4))
    assert snaps[3] == (None, 4, snaps[1][2])


def test_join_at_chunk_boundary_like_jax():
    boards = _mixed_batch(b=2, seed=9)

    def scenario(make):
        events = {0: [], 1: []}
        table = make(CONWAY, (32, 32), 2, max_chunk=2)
        s_a = table.admit(boards[0], 6, on_event=events[0].append)
        table.advance()  # a alone at turn 2
        s_b = table.admit(boards[1], 4, on_event=events[1].append)
        _drive(table)
        return _record([s_a, s_b], events)

    rec = _both(scenario)
    assert rec["turns"] == [6, 4]
    assert np.array_equal(np.array(rec["results"][0], np.uint8), _seq(boards[0], 6))
    assert np.array_equal(np.array(rec["results"][1], np.uint8), _seq(boards[1], 4))


def test_dead_universe_retires_early_only_without_b0():
    """All-dead universes retire at the first boundary under Conway; under
    a B0 rule a dead board births, so it runs its whole budget."""
    b0 = LifeRule.from_rulestring("B0/S8", name="b0")
    dead = np.zeros((32, 32), np.uint8)

    def scenario(make, rule):
        events = {0: []}
        table = make(rule, (32, 32), 1, max_chunk=2)
        s = table.admit(dead, 7, on_event=events[0].append)
        _drive(table)
        return _record([s], events)

    conway = scenario(_port_table, CONWAY)
    assert conway == scenario(_jax_table, CONWAY)
    assert [e[1] for e in conway["events"][0] if e[0] == "TurnComplete"] == [2]
    assert conway["turns"] == [7] and not np.any(conway["results"][0])
    births = scenario(_port_table, b0)
    assert births == scenario(_jax_table, b0)
    assert [e[1] for e in births["events"][0] if e[0] == "TurnComplete"] == [2, 4, 6, 7]
    assert np.array_equal(np.array(births["results"][0], np.uint8), _seq(dead, 7, b0))


def test_byte_tier_table_16x16_matches_jax():
    boards = _mixed_batch(b=4, h=16, w=16, seed=11)

    def scenario(make):
        events = {i: [] for i in range(4)}
        table = make(HIGHLIFE, (16, 16), 4)
        sessions = [table.admit(boards[i], t, on_event=events[i].append)
                    for i, t in enumerate((3, 10, 6, 1))]
        _drive(table)
        return _record(sessions, events)

    rec = _both(scenario)
    assert isinstance(_port_table(HIGHLIFE, (16, 16), 1)._plane, BatchBytePlane)
    assert isinstance(_port_table(HIGHLIFE, (32, 32), 1)._plane, BatchBitPlane)
    for i, t in enumerate((3, 10, 6, 1)):
        assert np.array_equal(np.array(rec["results"][i], np.uint8), _seq(boards[i], t, HIGHLIFE))


def test_fail_all_completes_every_waiter_with_the_error():
    boards = _mixed_batch(b=3, seed=13)
    table = _port_table(CONWAY, (32, 32), 4)
    active = table.admit(boards[2], 9)
    table.advance()
    pending = table.admit(boards[1], 9)
    boom = RuntimeError("driver failed")
    table.fail_all(boom)
    assert active.done.is_set() and pending.done.is_set()
    assert active.error is boom and pending.error is boom
    assert table.occupancy == 0 and table._state is None


def test_snapshot_races_the_driver_without_tearing():
    """Handler threads snapshot while the driver advances and compacts:
    every (world, turn, alive) triple is the oracle's at that turn."""
    boards = _mixed_batch(b=4, seed=14)
    table = _port_table(CONWAY, (32, 32), 4, max_chunk=1)
    sessions = [table.admit(boards[i], t) for i, t in enumerate((10, 17, 25, 32))]
    seen, errors = [], []
    stop = threading.Event()

    def poll(i):
        try:
            while not stop.is_set():
                seen.append((i, *table.snapshot(sessions[i], include_world=True)))
                time.sleep(0.002)  # leave the driver the interpreter
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=poll, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        _drive(table, limit=100)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert not errors and not any(t.is_alive() for t in threads)
    checked = 0
    for i, world, turn, alive in seen[:: max(1, len(seen) // 40)]:
        want = _seq(boards[i], turn)
        assert np.array_equal(world, want) and alive == int(np.count_nonzero(want))
        checked += 1
    assert checked > 0
