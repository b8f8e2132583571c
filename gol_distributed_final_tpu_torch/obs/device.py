"""The card's telemetry: each kernel launch's device time, its operation
and byte counts, the kernels' build times, and per-device HBM gauges.

The host-side registry (obs/metrics.py) answers "where did WALL time go";
this module answers what happens on the card:

* **How long did each launch take on the card?** Each kernel wrapper
  (ops/whole_board.py, batch_board.py, tiled.py, byte_board.py,
  byte_tiled.py, strip_steps.py) brackets its launch with ``begin`` and
  ``end``: with metrics on, a pair of ``torch.cuda.Event(enable_timing=
  True)`` recorded on the launch's stream. ``gol_kernel_dispatch_seconds
  {site}`` is the launch's DEVICE time from that pair — the one stated
  difference from the JAX package, which timed the host wall of a
  synchronous dispatch. On an asynchronous card a host wall times the
  enqueue, and the achieved rates would read above the card's peaks.
* **What does a launch cost?** ``gol_kernel_flops{site}`` holds the int32
  instruction count of the launch's roofline bound (``ops/bitpack.py::
  ops_per_word`` per word a turn, ``byte_ops_per_cell`` for the byte
  kernels), and ``gol_kernel_bytes_accessed{site}`` its bytes: each input
  read once, each output written once. The per-site sums of both over
  every launch feed obs/perf.py's achieved rates exactly.
* **How long did each kernel take to build?** ``gol_compile_seconds
  {site}`` is the nvcc wall of the site's source (ops/_build.py), observed
  once per build; ``gol_compile_cache_requests_total`` and ``..._misses
  _total`` count that build cache.
* **How close is HBM to the ceiling?** ``torch.cuda.memory_stats``
  sampled per turn-chunk in the engine (``gol_device_hbm_bytes_in_use
  {device}``, ``..._peak_bytes``, ``..._bytes_limit``, the limit being the
  card's total memory, read once) plus a process-local high-water mark
  (``hbm_peak_observed``) that the RunReport publishes.
* **How long did a chunk take on the card?** With attribution on
  (obs/perf.py), the engine opens a chunk with ``chunk_begin`` (a
  timing event a card, before its launches) and closes it with
  ``chunk_end`` on the fence it records anyway after them.
  ``gol_turn_segment_seconds{engine,device_compute}`` is that pair's
  device time, folded in by ``resolve`` like a launch's.

**Nothing here synchronises the card.** ``end`` appends the event pair to
a bounded per-site list; ``resolve`` folds in (``elapsed_time``) only
pairs whose end event ``query()``s complete, and returns their events to a
free list the next launches take theirs from. The engine calls
``resolve`` after the synchronisations it already makes (the chunk's
synchronised wall, its pipeline fences), and a ``Status`` poll or a
report resolves what has completed. Only a list at its bound with none of
it complete waits for its oldest launch. ``memory_stats`` reads the
caching allocator's counters and does not synchronise either.

On the CPU a wrapper runs its kernel's plain version, synchronously, so
``begin``/``end`` time it by the host clock: the CPU is the device there.

With metrics off ``begin`` is one flag check and returns None, and the
wrapper skips ``end``: no event is created.

Site labels are the JAX package's stable set (README "Device telemetry";
its ``obs/lint.py``); each port wrapper reports under the site of the
reference call it replaces:

    pallas.vmem_byte        K5, ops/byte_board.py            (pallas_step_n_fn)
    pallas.vmem_bit         K1, ops/whole_board.py           (pallas_step_n_fn)
    pallas.vmem_bit_cluster K1's cluster route, ops/whole_board.py (a single
                            board in bands over a thread block cluster,
                            whatever site its caller names; the port's own)
    pallas.vmem_bit_batch   K2, ops/batch_board.py
    pallas.tiled            the tiled kernel, ops/tiled.py
    pallas.fused_bit        K1 under FusedBitPlane / the bit ladder
    pallas.fused_byte       K5's ladder and K6, ops/fused.py
    pallas.fused_tiled      the tiled kernel under the bit ladder
    pallas.fused_bit_batch  K2 under the session table's counted batch
    fused.strip             W, ops/strip_steps.py
    halo.bit / halo.byte    a mesh block's step (parallel/)
    bitpack.xla_step        the torch-op bitboard (ops/bitpack.py)
    bitpack.alive_history   K1's history mode, ops/whole_board.py::history
                            (the JAX function is an XLA scan with no site)

The sparse kernel (ops/sparse_tiles.py) has no site, as the JAX package
meters that plane by its tiles only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

import torch

from . import instruments as _ins
from . import metrics as _metrics

#: event pairs a site may hold unresolved; past it ``end`` folds in what
#: has completed and, if the card is that far behind, waits for the oldest
#: pair: memory stays bounded without dropping a launch from the sums
MAX_PENDING = 4096

# per-site dispatch accounting (obs/perf.py's roofline join): every
# timed launch adds its int32 operations, its bytes and its device time.
# The keys are the JAX package's (``flops``, ``wall_s``), read by the
# copied obs/perf.py; here "flops" are int32 operations and "wall_s" is
# device time from the events.
_DISPATCH_STATS: Dict[str, list] = {}  # site -> [ops, bytes, seconds, calls]
_PENDING: Dict[str, deque] = {}  # site -> deque of (start, end, ops, bytes, stream)
_DISPATCH_LOCK = threading.Lock()
# one resolver at a time: a resolver folds in, without a query of their
# own, the pairs it counted behind a completed newest one
_RESOLVE_LOCK = threading.Lock()
# timing events whose pair has been folded in, by device index: a launch
# takes two from here instead of creating them (list append and pop are
# atomic, so the wrappers' threads share the lists without the lock)
_FREE_EVENTS: Dict[int, list] = {}
# the engine's chunks (chunk_begin/chunk_end): [(start, stop) a card] in
# launch order, under _DISPATCH_LOCK
_CHUNKS: deque = deque()


def _event(index: int):
    free = _FREE_EVENTS.get(index)
    if free:
        try:
            return free.pop()
        except IndexError:  # another thread took the last one
            pass
    return torch.cuda.Event(enable_timing=True)


def timing_stream(device):
    """The stream ``begin`` should record on for launches on ``device``,
    fetched once for a ladder of launches: the device's current stream
    with metrics on, None (one flag check) with metrics off or off the
    card."""
    if not _metrics.enabled() or device.type != "cuda":
        return None
    return torch.cuda.current_stream(device)


def begin(device, stream=None):
    """Mark the start of a launch on ``device`` (a ``torch.device``): a
    start event recorded on ``stream`` (the device's current stream when
    None; a wrapper that has the stream passes it) for a CUDA device, the
    host clock for the CPU. None when metrics are off, and then the
    caller skips ``end``."""
    if not _metrics.enabled():
        return None
    if device.type != "cuda":
        return time.perf_counter()
    if stream is None:
        stream = torch.cuda.current_stream(device)
    start = _event(stream.device_index)
    start.record(stream)
    return start, stream


def end(site: str, device, started, ops: float, nbytes: float) -> None:
    """Close the launch ``begin`` opened: on the card, record the end
    event on the same stream and queue the pair, to be folded in once it
    has completed (``resolve``); on the CPU, note the host wall at once."""
    if device.type != "cuda":
        _note_dispatch(site, ops, nbytes, time.perf_counter() - started)
        return
    start, stream = started
    stop = _event(stream.device_index)
    stop.record(stream)
    with _DISPATCH_LOCK:
        pending = _PENDING.get(site)
        if pending is None:
            pending = _PENDING[site] = deque()
        pending.append((start, stop, ops, nbytes, stream))
        full = len(pending) > MAX_PENDING
    if full and not resolve(site):
        pending[0][1].synchronize()
        resolve(site)


def _note_dispatch(site: str, ops: float, nbytes: float, seconds: float) -> None:
    """Fold one finished launch into the per-site roofline accumulators,
    the gol_kernel_dispatch_seconds histogram and the latest launch's
    operation and byte gauges."""
    _note_many(site, [(ops, nbytes, seconds)])


def _note_many(site: str, folded: list) -> None:
    """Fold finished launches ``[(ops, bytes, seconds), ...]`` of one site
    in: one histogram observation each, the sums under one lock, the
    gauges set to the last launch's counts."""
    if not folded:
        return
    hist = _ins.KERNEL_DISPATCH_SECONDS.labels(site)
    for _, _, seconds in folded:
        hist.observe(seconds)
    _ins.KERNEL_FLOPS.labels(site).set(folded[-1][0])
    _ins.KERNEL_BYTES_ACCESSED.labels(site).set(folded[-1][1])
    with _DISPATCH_LOCK:
        stats = _DISPATCH_STATS.setdefault(site, [0.0, 0.0, 0.0, 0])
        for ops, nbytes, seconds in folded:
            stats[0] += ops
            stats[1] += nbytes
            stats[2] += seconds
        stats[3] += len(folded)


def chunk_begin(devices) -> list:
    """Start events, one a CUDA device of ``devices``, recorded on each
    device's current stream before a chunk's launches."""
    starts = []
    for device in devices:
        starts.append(torch.cuda.Event(enable_timing=True))
        starts[-1].record(torch.cuda.current_stream(device))
    return starts


def chunk_end(starts: list, stops: list) -> None:
    """Queue an engine chunk's pairs: ``stops`` are timing events recorded,
    in ``starts``' device order, after its launches. ``resolve`` observes
    the slowest device's time as the engine's ``device_compute`` once every
    stop has completed; nothing waits for it."""
    with _DISPATCH_LOCK:
        _CHUNKS.append(list(zip(starts, stops)))


def _resolve_chunks() -> None:
    """Fold in the completed engine chunks, oldest first, stopping at the
    first incomplete one; its caller holds ``_RESOLVE_LOCK``."""
    folded = []
    with _DISPATCH_LOCK:
        while _CHUNKS and all(stop.query() for _, stop in _CHUNKS[0]):
            folded.append(_CHUNKS.popleft())
    for pairs in folded:
        seconds = max(start.elapsed_time(stop) for start, stop in pairs) / 1e3
        _ins.TURN_SEGMENT_SECONDS.labels("engine", "device_compute").observe(seconds)


def resolve(site: Optional[str] = None) -> int:
    """Fold in every queued launch (of ``site``, or of every site) whose
    end event has completed, oldest first, stopping at a site's first
    incomplete one: ``query()`` only, never a wait. A stream runs in
    order, so once a site's newest end event has completed, every older
    pair on its stream has too and is folded without a query of its own.
    The completed engine chunks (``chunk_end``) are folded in first.
    Returns the launches folded in. The engine calls it after the
    synchronisations it makes, and ``dispatch_stats`` (a Status poll, a
    report) before it reads."""
    done = 0
    with _RESOLVE_LOCK:
        _resolve_chunks()
    with _RESOLVE_LOCK, _DISPATCH_LOCK:
        sites = [site] if site is not None else list(_PENDING)
    for name in sites:
        with _RESOLVE_LOCK:
            done += _resolve_site(name)
    return done


def _resolve_site(name: str) -> int:
    """``resolve`` for one site, its caller holding ``_RESOLVE_LOCK``."""
    folded = []
    with _DISPATCH_LOCK:
        pending = _PENDING.get(name)
        newest = pending[-1] if pending else None
        # the pairs queued up to the newest one: older on their stream
        trusted = len(pending) if pending else 0
    done_stream = newest[4] if newest is not None and newest[1].query() else None
    if done_stream is None:
        trusted = 0
    while True:
        with _DISPATCH_LOCK:
            if not pending:
                break
            head = pending[0]
            if not (trusted > 0 and head[4] == done_stream) and not head[1].query():
                break
            pending.popleft()
        trusted -= 1
        start, stop, ops, nbytes, stream = head
        folded.append((ops, nbytes, start.elapsed_time(stop) / 1e3))
        free = _FREE_EVENTS.setdefault(stream.device_index, [])
        free.append(start)
        free.append(stop)
    _note_many(name, folded)
    return len(folded)


def pending_launches() -> int:
    """Launches queued and not yet folded in, over every site."""
    with _DISPATCH_LOCK:
        return sum(len(q) for q in _PENDING.values())


def dispatch_stats() -> Dict[str, dict]:
    """Per-site dispatch totals of the launches resolved so far:
    ``{site: {flops, bytes_accessed, wall_s, calls}}`` — obs/perf.py's
    achieved-throughput input (int32 operations and device seconds)."""
    resolve()
    with _DISPATCH_LOCK:
        return {
            site: {
                "flops": s[0],
                "bytes_accessed": s[1],
                "wall_s": s[2],
                "calls": s[3],
            }
            for site, s in _DISPATCH_STATS.items()
        }


def reset_dispatch() -> None:
    """Forget the dispatch accumulators and queued pairs (tests / bench
    isolation)."""
    with _DISPATCH_LOCK:
        _DISPATCH_STATS.clear()
        _PENDING.clear()
        _FREE_EVENTS.clear()
        _CHUNKS.clear()


# -- kernel builds ------------------------------------------------------------

#: ops/_build.py's source -> the site its build time is reported under
#: (the sparse kernel's source has no site: module docstring)
SOURCE_SITES = {
    "whole_board": "pallas.vmem_bit",
    "tiled": "pallas.tiled",
    "byte_board": "pallas.vmem_byte",
    "byte_tiled": "pallas.fused_byte",
    "strip_steps": "fused.strip",
}


def note_build_request(source: str) -> None:
    """A kernel library was asked for (ops/_build.load's first call for a
    source in this process)."""
    if _metrics.enabled() and source in SOURCE_SITES:
        _ins.COMPILE_CACHE_REQUESTS_TOTAL.labels(SOURCE_SITES[source]).inc()


def note_build(source: str, seconds: float) -> None:
    """One nvcc build of ``source`` finished in ``seconds``: a miss of the
    build cache and one compile observation."""
    if _metrics.enabled() and source in SOURCE_SITES:
        site = SOURCE_SITES[source]
        _ins.COMPILE_CACHE_MISSES_TOTAL.labels(site).inc()
        _ins.COMPILE_SECONDS.labels(site).observe(seconds)


# -- HBM sampling -------------------------------------------------------------

# per-device high-water mark of bytes_in_use, across every sample this
# process ever took — what the RunReport publishes as the peak SEEN, not
# just the peak at the final sample
_PEAK_OBSERVED: Dict[str, int] = {}
_PEAK_LOCK = threading.Lock()
_LIMITS: Dict[int, int] = {}  # device index -> total memory, read once

# tri-state discovery: None = never probed, False = no CUDA (CPU) — later
# samples return immediately, True = supported
_HBM_SUPPORTED: Optional[bool] = None


def _memory_stats(index: int) -> Optional[dict]:
    """The subset of the caching allocator's statistics the gauges read
    (``allocated_bytes.all.current`` and ``.peak`` of
    ``torch.cuda.memory_stats``, read from the nested form, which skips
    the flattening of every statistic), with the card's total memory as
    the limit."""
    allocated = torch.cuda.memory_stats_as_nested_dict(index).get("allocated_bytes", {})
    if index not in _LIMITS:
        _LIMITS[index] = int(torch.cuda.get_device_properties(index).total_memory)
    return {
        "bytes_in_use": int(allocated.get("all", {}).get("current", 0)),
        "peak_bytes_in_use": int(allocated.get("all", {}).get("peak", 0)),
        "bytes_limit": _LIMITS[index],
    }


def sample_hbm(devices=None) -> Dict[str, dict]:
    """One ``memory_stats`` sweep over the local cards: sets the HBM
    gauges and advances the process-local peak-observed high-water mark.

    Returns ``{device_index: {bytes_in_use, peak_bytes_in_use,
    bytes_limit}}`` — empty without CUDA. The unsupported discovery is
    cached, so the engine can call this per turn-chunk and a CPU run pays
    one probe total. ``devices`` overrides the local cards: objects with
    ``id`` and ``memory_stats()`` (the test hook, as in the JAX
    package)."""
    global _HBM_SUPPORTED
    probed_default = devices is None
    if probed_default:
        if _HBM_SUPPORTED is False:
            return {}
        if not torch.cuda.is_available():
            _HBM_SUPPORTED = False
            return {}
        devices = [_Card(i) for i in range(torch.cuda.device_count())]
    out: Dict[str, dict] = {}
    for dev in devices:
        try:
            stats = dev.memory_stats()
        # gol: allow(hygiene): per-device probe — a device whose stats
        # cannot be read degrades to 'no gauge', by design
        except Exception:
            stats = None
        if not stats:
            continue
        label = str(getattr(dev, "id", len(out)))
        in_use = stats.get("bytes_in_use")
        peak = stats.get("peak_bytes_in_use", in_use)
        limit = stats.get("bytes_limit")
        if in_use is not None:
            _ins.HBM_BYTES_IN_USE.labels(label).set(in_use)
            with _PEAK_LOCK:
                _PEAK_OBSERVED[label] = max(_PEAK_OBSERVED.get(label, 0), int(in_use))
        if peak is not None:
            _ins.HBM_PEAK_BYTES.labels(label).set(peak)
            with _PEAK_LOCK:
                _PEAK_OBSERVED[label] = max(_PEAK_OBSERVED.get(label, 0), int(peak))
        if limit is not None:
            _ins.HBM_BYTES_LIMIT.labels(label).set(limit)
        out[label] = {
            "bytes_in_use": in_use,
            "peak_bytes_in_use": peak,
            "bytes_limit": limit,
        }
    if probed_default:
        # only a real probe decides the discovery, and once a sweep has
        # produced stats a transient failed sweep does not disable every
        # later sample
        if out:
            _HBM_SUPPORTED = True
        elif _HBM_SUPPORTED is None:
            _HBM_SUPPORTED = False
    return out


class _Card:
    """One local CUDA device as ``sample_hbm`` reads it."""

    __slots__ = ("id",)

    def __init__(self, index: int):
        self.id = index

    def memory_stats(self) -> Optional[dict]:
        return _memory_stats(self.id)


def card_memory_stats(index: int) -> Optional[dict]:
    """The gauges' subset of one card's memory stats (obs/report.py's
    inventory); None without CUDA."""
    if not torch.cuda.is_available():
        return None
    return _memory_stats(index)


def hbm_peak_observed() -> Dict[str, int]:
    """Per-device high-water ``bytes_in_use`` across every sample this
    process took — what the RunReport publishes so a mid-run spike is
    visible in the final artifact even after it subsides."""
    with _PEAK_LOCK:
        return dict(_PEAK_OBSERVED)


def reset_hbm() -> None:
    """Forget peaks and the supported/unsupported discovery (tests)."""
    global _HBM_SUPPORTED
    with _PEAK_LOCK:
        _PEAK_OBSERVED.clear()
    _HBM_SUPPORTED = None
