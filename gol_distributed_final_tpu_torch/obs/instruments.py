"""Every metric the codebase records, declared in ONE place.

The names are a stable operator-facing contract: they appear in RunReport
JSON, in ``Status`` RPC payloads, and in Prometheus scrapes, so renaming
one is a breaking change. The README's "Observability" table documents
them all, and ``obs/lint.py`` (run by ``tests/test_obs.py``) fails the
build if this module and that table drift apart.

Conventions: seconds for every duration histogram (fixed DEFAULT_BUCKETS
edges — the exact-merge contract), ``_total`` suffix on counters,
``method``/``plane``/``site`` labels kept low-cardinality (RPC verb names,
plane kinds, compile-cache sites — never per-board values).

All instruments bind to the process-global default registry, which starts
DISABLED: importing this module from a hot path costs nothing until an
entry point calls ``metrics.enable()`` (the ``-metrics`` flags).
"""

from __future__ import annotations

from .metrics import registry

_R = registry()

# -- engine run loop (engine/engine.py) -------------------------------------

ENGINE_STEP_SECONDS = _R.histogram(
    "gol_engine_step_seconds",
    "Per-turn step time, dispatch wall / chunk turns (near-zero for "
    "pipelined async chunks; growth-phase chunks are synchronous and "
    "accurate). Count == turns evolved.",
)
ENGINE_DISPATCH_SECONDS = _R.histogram(
    "gol_engine_dispatch_seconds",
    "Per-chunk dispatch wall time (block_until_ready during chunk growth, "
    "enqueue-only once pipelined).",
)
ENGINE_PARK_SECONDS = _R.histogram(
    "gol_engine_park_seconds",
    "Time the run loop spent parked in the pause gate, per park.",
)
ENGINE_CHECKPOINT_SECONDS = _R.histogram(
    "gol_engine_checkpoint_seconds",
    "Periodic checkpoint write time (including failed attempts).",
)
ENGINE_TURNS_TOTAL = _R.counter(
    "gol_engine_turns_total", "Turns evolved by this process's engine."
)
ENGINE_CHUNKS_TOTAL = _R.counter(
    "gol_engine_chunks_total", "Chunk dispatches issued by the run loop."
)
ENGINE_CHUNK_SIZE = _R.gauge(
    "gol_engine_chunk_size", "Current turns-per-dispatch chunk size."
)
ENGINE_CHECKPOINT_ERRORS_TOTAL = _R.counter(
    "gol_engine_checkpoint_errors_total",
    "Periodic checkpoint attempts that failed (run continues).",
)

# -- controller / ticker (engine/controller.py) -----------------------------

CONTROLLER_TICK_SECONDS = _R.histogram(
    "gol_controller_tick_seconds",
    "Ticker count-only retrieve latency (the 2 s AliveCellsCount path).",
)
CONTROLLER_KEY_SECONDS = _R.histogram(
    "gol_controller_key_seconds",
    "Keypress handling latency, per key.",
    labelnames=("key",),
)
CONTROLLER_EMIT_SECONDS = _R.histogram(
    "gol_controller_emit_seconds",
    "Event-queue put latency on the controller's emit paths.",
)
CONTROLLER_EVENTS_TOTAL = _R.counter(
    "gol_controller_events_total",
    "Events emitted by the controller, by event type.",
    labelnames=("event",),
)
CONTROLLER_TICKER_WAKEUPS_TOTAL = _R.counter(
    "gol_controller_ticker_wakeups_total",
    "Ticker thread wake-ups, by reason: a tick due, a key queued, an idle "
    "key poll, or the thread's end once done is set (one a session).",
    labelnames=("reason",),
)

# -- RPC, both sides (rpc/client.py, rpc/server.py) -------------------------

RPC_CLIENT_REQUESTS_TOTAL = _R.counter(
    "gol_rpc_client_requests_total",
    "Outbound RPC calls issued, by verb.",
    labelnames=("method",),
)
RPC_CLIENT_ERRORS_TOTAL = _R.counter(
    "gol_rpc_client_errors_total",
    "Outbound RPC calls that raised RpcError, by verb.",
    labelnames=("method",),
)
RPC_CLIENT_REQUEST_SECONDS = _R.histogram(
    "gol_rpc_client_request_seconds",
    "Outbound RPC round-trip latency (send to reply), by verb.",
    labelnames=("method",),
)
RPC_CLIENT_SENT_BYTES_TOTAL = _R.counter(
    "gol_rpc_client_sent_bytes_total",
    "Request frame bytes (header + pickle payload) sent, by verb.",
    labelnames=("method",),
)
RPC_CLIENT_RECEIVED_BYTES_TOTAL = _R.counter(
    "gol_rpc_client_received_bytes_total",
    "Reply frame bytes received, by verb.",
    labelnames=("method",),
)
RPC_SERVER_REQUESTS_TOTAL = _R.counter(
    "gol_rpc_server_requests_total",
    "Inbound RPC calls dispatched, by verb.",
    labelnames=("method",),
)
RPC_SERVER_ERRORS_TOTAL = _R.counter(
    "gol_rpc_server_errors_total",
    "Inbound RPC calls answered with an error reply, by verb.",
    labelnames=("method",),
)
RPC_SERVER_REQUEST_SECONDS = _R.histogram(
    "gol_rpc_server_request_seconds",
    "Inbound RPC handler latency (dispatch to reply written), by verb.",
    labelnames=("method",),
)
RPC_SERVER_RECEIVED_BYTES_TOTAL = _R.counter(
    "gol_rpc_server_received_bytes_total",
    "Request frame bytes received, by verb.",
    labelnames=("method",),
)
RPC_SERVER_SENT_BYTES_TOTAL = _R.counter(
    "gol_rpc_server_sent_bytes_total",
    "Reply frame bytes sent, by verb.",
    labelnames=("method",),
)

# -- wire data plane (rpc/protocol.py frames, rpc/broker.py wire modes) -----

WIRE_BYTES_TOTAL = _R.counter(
    "gol_wire_bytes_total",
    "Frame bytes this process's RPC clients moved, by verb and direction "
    "(sent/received) — the data-plane comms meter the wire-mode bench "
    "cases embed and scripts/bench_diff gates.",
    labelnames=("verb", "direction"),
)
TURN_BATCH_SIZE = _R.histogram(
    "gol_turn_batch_size",
    "Turns advanced per workers-backend RPC batch (resident wire mode: K "
    "turns per StripStep round-trip; full/haloed: always 1).",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
)
STRIP_RESYNC_TOTAL = _R.counter(
    "gol_strip_resync_total",
    "Resident-mode full strip re-syncs (StripFetch gathers): -sync-interval "
    "expiry, snapshot/pause/checkpoint/run-end boundaries, and loss "
    "recovery.",
)

# -- multi-universe serving (engine/sessions.py, rpc/broker.py scheduler) ---

SESSIONS_ACTIVE = _R.gauge(
    "gol_sessions_active",
    "Universes currently packed (or pending admission) in this process's "
    "device-batched session table.",
)
SESSIONS_ADMITTED_TOTAL = _R.counter(
    "gol_sessions_admitted_total",
    "Sessions admitted into the batched session table since start.",
)
SESSIONS_REJECTED_TOTAL = _R.counter(
    "gol_sessions_rejected_total",
    "Session admissions refused, by reason: 'capacity' (table full), "
    "'geometry' (board shape differs from the batch's), 'rule' (rule "
    "differs from the batch's), 'turns' (non-positive budget), 'tag' "
    "(client session tag already in use).",
    labelnames=("reason",),
)
SESSION_TURNS_TOTAL = _R.counter(
    "gol_session_turns_total",
    "Universe-turns evolved by the batched session driver (each k-turn "
    "batched dispatch adds k x active universes).",
)

# -- serving SLOs (obs/timeline.py sampler, obs/slo.py rules) ---------------

SESSION_TURN_SECONDS = _R.histogram(
    "gol_session_turn_seconds",
    "Per-universe-turn serving latency of the batched session driver "
    "(engine/sessions.py): each k-turn batched dispatch records its wall "
    "normalized per universe-turn, count == universe-turns — the "
    "latency objective the 'session-turn-latency' SLO rule evaluates.",
)
SESSION_ADMIT_WAIT_SECONDS = _R.histogram(
    "gol_session_admit_wait_seconds",
    "SessionRun admission latency (rpc/broker.SessionScheduler.submit "
    "entry to the session joining the table) — the 'session-admit-"
    "latency' SLO rule's feed; growth means the driver thread is "
    "starved or the table lock is contended.",
)
RPC_DISPATCH_SECONDS = _R.histogram(
    "gol_rpc_dispatch_seconds",
    "Inbound RPC HANDLER time only (fn(request) inside the dispatch, "
    "excluding frame parse and reply serialisation — "
    "gol_rpc_server_request_seconds covers the whole dispatch), by verb "
    "— the 'rpc-dispatch-latency' SLO rule's feed. Verbs that BLOCK by "
    "contract (Run, SessionRun: rpc/protocol.BLOCKING_METHODS) are "
    "excluded; their handler wall is the run length, not a latency.",
    labelnames=("method",),
)
SCATTER_DEADLINE_SECONDS = _R.gauge(
    "gol_scatter_deadline_seconds",
    "The workers backend's current per-scatter reply deadline (pinned "
    "by -rpc-deadline, else adaptive ~20x the turn-time EWMA): the "
    "'scatter-deadline-growth' SLO rule alerts on its drift — the "
    "cluster getting slower before anything has failed.",
)
SLO_ALERTS_TOTAL = _R.counter(
    "gol_slo_alerts_total",
    "SLO rule firings (obs/slo.py RuleBook transitions to firing), by "
    "rule name and severity (page/warn). Active alert STATE lives in "
    "the Status payload's 'alerts' field; this counter is the "
    "scrape-able history.",
    labelnames=("rule", "severity"),
)

# -- blackbox canary + open-loop load harness (obs/canary.py,
#    obs/loadgen.py) ---------------------------------------------------------

CANARY_PROBES_TOTAL = _R.counter(
    "gol_canary_probes_total",
    "Blackbox canary probes (obs/canary.py: a known-oracle universe "
    "through the full RPC + session path), by result: 'ok' (bit-exact), "
    "'corrupt' (the serving path returned WRONG bits — the silent class "
    "the 'canary-failure' SLO rule pages on), 'error' (the path failed "
    "loudly: transport/reply error or timeout).",
    labelnames=("result",),
)
CANARY_LATENCY_SECONDS = _R.histogram(
    "gol_canary_latency_seconds",
    "End-to-end canary probe latency (submit to verified final board), "
    "success or failure — a slow canary is an early latency signal from "
    "the exact path tenants use.",
)
LOADGEN_ADMIT_TO_FIRST_TURN_SECONDS = _R.histogram(
    "gol_loadgen_admit_to_first_turn_seconds",
    "CLIENT-side admission-to-first-turn latency measured by the "
    "open-loop load generator (obs/loadgen.py): session arrival to the "
    "first turn visible via the tagged retrieve poller (quantized by "
    "the poll cadence; a session that drains before the first poll "
    "records its end-to-end wall) — the ROADMAP front-door objective.",
)
LOADGEN_SESSION_SECONDS = _R.histogram(
    "gol_loadgen_session_seconds",
    "CLIENT-side end-to-end session latency measured by the open-loop "
    "load generator: arrival to final board.",
)
LOADGEN_SESSIONS_TOTAL = _R.counter(
    "gol_loadgen_sessions_total",
    "Load-generator session outcomes, by 'ok' / 'rejected' (structured "
    "SessionRejected reply — reasons break out in the loadgen summary "
    "and the per-tenant accounting ledger) / 'error'.",
    labelnames=("outcome",),
)

# -- data integrity (rpc/integrity.py: checked frames, attestation,
#    verified checkpoints) ---------------------------------------------------

INTEGRITY_CHECKS_TOTAL = _R.counter(
    "gol_integrity_checks_total",
    "Integrity verifications performed: in-header frame crc words verified, "
    "resident-strip digest-chain / edge-digest / halo cross-attestation "
    "comparisons on the broker.",
)
INTEGRITY_FAILURES_TOTAL = _R.counter(
    "gol_integrity_failures_total",
    "Integrity verifications that FAILED, by kind: 'frame' (checksum "
    "mismatch — the frame was never parsed), 'strip' (a resident strip's "
    "pre-batch digest broke the committed chain: in-place corruption), "
    "'edges' (reply edge rows disagree with their attested digest), "
    "'attest' (neighbouring strips' redundant boundary-band digests "
    "disagree: wrong compute), 'fetch' (a gathered strip does not hash to "
    "the committed chain). Every failure routes the suspect through the "
    "loss/quarantine machinery.",
    labelnames=("kind",),
)
CKPT_VERIFY_TOTAL = _R.counter(
    "gol_ckpt_verify_total",
    "Checkpoint digest verifications (engine/checkpoint.py "
    "load_verified_checkpoint), by result (ok/fail) — every -resume "
    "attempt and -ckpt-keep fallback probe counts here.",
    labelnames=("result",),
)

# -- fault tolerance (rpc/client.py reconnect, rpc/broker.py recovery) ------

RPC_RETRIES_TOTAL = _R.counter(
    "gol_rpc_retries_total",
    "RPC client transport reconnect attempts (capped jittered exponential "
    "backoff). In-flight calls fail and are never silently re-sent; only "
    "the transport is retried.",
)
WORKER_LOST_TOTAL = _R.counter(
    "gol_worker_lost_total",
    "Workers dropped from the broker's scatter set mid-run (connection "
    "loss or scatter-deadline expiry) — each loss re-splits the rows over "
    "the survivors.",
)
WORKER_READMITTED_TOTAL = _R.counter(
    "gol_worker_readmitted_total",
    "Lost or never-connected roster addresses readmitted by the broker's "
    "background probe (a full worker Status round-trip); the row split "
    "re-expands at the next turn.",
)
TURN_RETRY_TOTAL = _R.counter(
    "gol_turn_retry_total",
    "Scatter/gather turns recomputed after losing workers (the same turn "
    "is retried from the committed pre-turn world — never a skipped or "
    "half-applied turn).",
)
AUTO_CHECKPOINT_TOTAL = _R.counter(
    "gol_auto_checkpoint_total",
    "Periodic broker auto-checkpoints written (-auto-checkpoint; "
    "tmp-then-rename, failures logged and excluded).",
)

# -- kernel-tier selection + compile cache (ops/auto.py, parallel/*) --------

OPS_PLANE_SELECTED_TOTAL = _R.counter(
    "gol_ops_plane_selected_total",
    "Automatic data-plane routing decisions, by selected tier "
    "(bitplane / sparse_bitplane / roll_stencil / pallas_bit_step / "
    "packed_xla_step, plus the batched family's batch_bitplane / "
    "batch_roll_stencil). Cached per (rule, shape): counts DECISIONS, "
    "not admissions.",
    labelnames=("plane",),
)
COMPILE_CACHE_REQUESTS_TOTAL = _R.counter(
    "gol_compile_cache_requests_total",
    "Compiled-program cache lookups on the mesh step paths, by site.",
    labelnames=("site",),
)
COMPILE_CACHE_MISSES_TOTAL = _R.counter(
    "gol_compile_cache_misses_total",
    "Cache lookups that traced+compiled a new program (hits = requests "
    "- misses), by site.",
    labelnames=("site",),
)

# -- halo-exchange data planes (parallel/halo.py, parallel/bit_halo.py) -----

HALO_DISPATCH_SECONDS = _R.histogram(
    "gol_halo_dispatch_seconds",
    "Host-side wall time of one mesh step_n dispatch (trace/compile on "
    "first call, enqueue after; device-side exchange time lives in the "
    "jax.profiler trace), by plane.",
    labelnames=("plane",),
)
HALO_EXCHANGES_TOTAL = _R.counter(
    "gol_halo_exchanges_total",
    "Halo exchanges (one rows+cols ppermute pair) issued inside mesh "
    "dispatches, by plane.",
    labelnames=("plane",),
)

# -- device / XLA telemetry (obs/device.py) ---------------------------------

COMPILE_SECONDS = _R.histogram(
    "gol_compile_seconds",
    "Wall time of one explicit XLA lower+compile at an instrumented "
    "compile site (obs/device.instrument_jit), by site.",
    labelnames=("site",),
)
KERNEL_FLOPS = _R.gauge(
    "gol_kernel_flops",
    "XLA cost-analysis FLOP estimate of the most recently compiled "
    "program at a site (Lowered.cost_analysis).",
    labelnames=("site",),
)
KERNEL_BYTES_ACCESSED = _R.gauge(
    "gol_kernel_bytes_accessed",
    "XLA cost-analysis bytes-accessed estimate of the most recently "
    "compiled program at a site.",
    labelnames=("site",),
)
HBM_BYTES_IN_USE = _R.gauge(
    "gol_device_hbm_bytes_in_use",
    "Device memory in use (memory_stats bytes_in_use), sampled per "
    "turn-chunk and at checkpoints; absent on backends without memory "
    "stats (CPU).",
    labelnames=("device",),
)
HBM_PEAK_BYTES = _R.gauge(
    "gol_device_hbm_peak_bytes",
    "Device-reported peak memory in use (memory_stats peak_bytes_in_use).",
    labelnames=("device",),
)
HBM_BYTES_LIMIT = _R.gauge(
    "gol_device_hbm_bytes_limit",
    "Device memory capacity (memory_stats bytes_limit).",
    labelnames=("device",),
)

# -- performance attribution (obs/perf.py roofline, obs/critical.py
#    straggler/critical-path, dispatch-wall decomposition) -------------------

KERNEL_DISPATCH_SECONDS = _R.histogram(
    "gol_kernel_dispatch_seconds",
    "Host-side wall of one instrumented compiled-executable call "
    "(obs/device.py AOT path), by site — the measured-dispatch-wall half "
    "of the roofline join (gol_kernel_flops / _bytes_accessed are the "
    "cost half). Pipelined callers that only enqueue record enqueue "
    "time; callers that sync (growth chunks, count reductions) record "
    "real device wall — the honest-caveat split the README documents.",
    labelnames=("site",),
)
KERNEL_ACHIEVED_FLOPS = _R.gauge(
    "gol_kernel_achieved_flops",
    "Achieved FLOP/s at a kernel site: XLA cost-analysis flops executed "
    "divided by measured dispatch wall, over every instrumented call so "
    "far (obs/perf.refresh_metrics sets it on Status polls and report "
    "writes).",
    labelnames=("site",),
)
KERNEL_ACHIEVED_BYTES = _R.gauge(
    "gol_kernel_achieved_bytes_per_s",
    "Achieved memory throughput at a kernel site: cost-analysis bytes "
    "accessed divided by measured dispatch wall (gol_kernel_achieved_"
    "flops's memory twin).",
    labelnames=("site",),
)
KERNEL_BOUND = _R.gauge(
    "gol_kernel_bound",
    "Roofline classification of a kernel site against the calibrated "
    "device ceilings (obs/perf.py): 1 on the site's current class "
    "(compute-bound / memory-bound / launch-bound), 0 on the others.",
    labelnames=("site", "class"),
)
TURN_SEGMENT_SECONDS = _R.histogram(
    "gol_turn_segment_seconds",
    "Dispatch-wall decomposition: each turn-chunk/K-batch's wall split "
    "into host_prep (planning, encode, request assembly), "
    "device_compute (kernel/worker compute — block_until_ready delta "
    "on the engine, the gating worker's reported service time on the "
    "broker), wire (round-trip wall minus service, workers backend "
    "only), and demux (reply validation, commit, event fan-out), by "
    "component (engine / sessions / broker) and segment — the "
    "WHERE-TIME-GOES panel's feed.",
    labelnames=("component", "segment"),
)
STRIP_STEP_SECONDS = _R.histogram(
    "gol_strip_step_seconds",
    "Per-worker StripStep round-trip wall as the broker measured it "
    "(resident wire mode), by worker address — the straggler/critical-"
    "path feed (obs/critical.py): per K-batch the slowest of these "
    "gated the gather.",
    labelnames=("addr",),
)
WORKER_SKEW_RATIO = _R.gauge(
    "gol_worker_skew_ratio",
    "Worst per-worker service-time skew: the slowest worker's "
    "service-time EWMA over the roster median (obs/critical.py), "
    "updated per K-batch — 1.0 is a balanced roster; the 'worker-skew' "
    "SLO GrowthRule alerts on its drift.",
)

# -- activity-sparse stepping (ops/sparse.py, rpc/ dirty-tile deltas,
#    engine early exits) ------------------------------------------------------

ACTIVE_TILES = _R.gauge(
    "gol_active_tiles",
    "Active tiles after the most recent sparse step chunk (ops/sparse."
    "SparseBitPlane) — or, on a resident-wire broker, dirty tiles "
    "reported by the roster's latest StripStep batch. The frontier size "
    "the SPARSITY watch panel tracks.",
)
TILE_SKIPS_TOTAL = _R.counter(
    "gol_tile_skips_total",
    "Tiles NOT computed by the sparse stepper (total tiles minus active, "
    "summed per turn): the work the activity bitmap saved vs the dense "
    "path.",
)
SPARSE_FRAME_BYTES_TOTAL = _R.counter(
    "gol_sparse_frame_bytes_total",
    "Payload bytes of dirty-tile delta frames shipped instead of full "
    "gathers (resident-wire StripFetch deltas: flat tile buffer + dirty "
    "bitmap) — the sparse-wire meter bench embeds as "
    "sparse_frame_bytes_per_sync and bench_diff gates.",
)
EARLY_EXIT_TOTAL = _R.counter(
    "gol_early_exit_total",
    "Runs short-circuited arithmetically instead of computed, by kind: "
    "'still' (activity bitmap drained — a still life's remaining turns "
    "are no-ops), 'period2' (board(t+2) == board(t): blinker-stable, "
    "remaining turns resolve by parity), 'dead' (a batched session "
    "universe's alive count hit 0 under a non-B0 rule: retired at the "
    "next boundary with its full budget credited).",
    labelnames=("kind",),
)

# -- 2-D tile data plane (rpc/broker.py -grid, rpc/worker.py tile batches) ---

# terse help by design: every registered family's help rides EVERY
# Status reply, which tests/test_tenants.py budgets at 64 KiB — the full
# semantics live in README "## 2-D tiles" (lint-tile-names enforces it)
HALO_BYTES_TOTAL = _R.counter(
    "gol_halo_bytes_total",
    "Resident-wire halo bytes moved, both directions, by axis "
    "(row/col edge bands, corner KxK blocks).",
    labelnames=("axis",),
)
TILE_EDGE_CELLS = _R.gauge(
    "gol_tile_edge_cells",
    "Cells in one K-batch halo exchange for the largest active tile "
    "(2K(th+tw) + 4K^2; a 1-column grid counts its 2KW strip rows).",
)
TILE_GRID_ROWS = _R.gauge(
    "gol_tile_grid_rows",
    "Row bands of the active resident tile layout (N for strips).",
)
TILE_GRID_COLS = _R.gauge(
    "gol_tile_grid_cols",
    "Column bands of the active resident tile layout (1 for strips).",
)

# -- fused K-turns-per-launch stepping (ops/fused.py, rpc/worker.py) ---------

FUSED_LAUNCHES_TOTAL = _R.counter(
    "gol_fused_launches_total",
    "Device kernel launches issued by the fused K-turns-per-launch tier "
    "(ops/fused.py: whole-board/tiled/batched ladders, fused step+count "
    "programs, the worker's fused strip batch). The denominator of the "
    "launch-amortisation story: turns advanced / launches issued is the "
    "effective K.",
)
FUSED_TURNS_PER_LAUNCH = _R.histogram(
    "gol_fused_turns_per_launch",
    "Turns advanced per fused device launch (the K distribution): full-K "
    "ladder launches observe K, pow2 remainder launches their size, and "
    "one-dispatch step+count programs the whole chunk. A collapse toward "
    "1 means the fusion is being bypassed — the launch floor is back.",
)
WHOLE_BOARD_LAUNCHES_TOTAL = _R.counter(
    "gol_whole_board_launches_total",
    "Launches of the whole-board kernel for a single board "
    "(ops/whole_board.py::step_n), by the route that ran: one block "
    "(block), or the board cut into bands over a thread block cluster, "
    "stepped in shared memory (cluster) or in registers (cluster_registers).",
    labelnames=("route",),
)
WHOLE_BOARD_MEETINGS_TOTAL = _R.counter(
    "gol_whole_board_meetings_total",
    "Meetings between the phases of the whole-board kernel's cluster "
    "launches for a single board (ops/whole_board.py::step_n), where each "
    "block takes its neighbours' band edges as its halo: one fewer than the "
    "launch's phases of halo-depth turns, by the route that ran (cluster or "
    "cluster_registers).",
    labelnames=("route",),
)
STRIP_ROWS_SKIPPED_TOTAL = _R.counter(
    "gol_strip_rows_skipped_total",
    "Row-steps the resident worker's dead-band skip did NOT compute "
    "(rows outside the live frontier's K-deep dependency cone, summed "
    "over the batch's steps — rpc/worker.strip_step_batch): the work the "
    "frontier bound saved vs stepping the full strip.",
)

# -- lifecycle journal (obs/journal.py) ---------------------------------------

JOURNAL_EVENTS_TOTAL = _R.counter(
    "gol_journal_events_total",
    "Lifecycle events appended to the durable journal (obs/journal.py), "
    "by event kind (the journal's declared EVENT_KINDS table: "
    "session.admit, chunk.commit, worker.lost, ckpt.write, ...). The "
    "per-process tally of the durable, HLC-stamped history that "
    "obs/history.py reconstructs cross-process timelines from.",
    labelnames=("kind",),
)
JOURNAL_BYTES_TOTAL = _R.counter(
    "gol_journal_bytes_total",
    "Bytes the journal's buffered writer appended to on-disk segments "
    "(crc-framed record lines, out/journal_<role>_<pid>*.jsonl).",
)
JOURNAL_ROTATIONS_TOTAL = _R.counter(
    "gol_journal_rotations_total",
    "Active journal segments retired down the generation chain when the "
    "size cap (rotate_bytes) was reached — the bounded-retention knob "
    "at work.",
)
JOURNAL_DROPS_TOTAL = _R.counter(
    "gol_journal_drops_total",
    "Journal records LOST to bounding — write-queue overflow on a "
    "wedged disk, plus every record inside a segment retired past the "
    "keep cap. Bounded retention may lose history; this meter is the "
    "contract that it never loses it silently.",
)

# -- continuous profiler (obs/profiler.py) -----------------------------------

PROFILE_SAMPLES_TOTAL = _R.counter(
    "gol_profile_samples_total",
    "Sampling ticks the continuous profiler (obs/profiler.py, the "
    "-profile [MS] flags) completed — each walks every thread's stack "
    "into the bounded call-tree trie. Rate vs the configured cadence "
    "shows adaptive backoff in action.",
)
PROFILE_BACKOFFS_TOTAL = _R.counter(
    "gol_profile_backoffs_total",
    "Times the profiler DOUBLED its own cadence because sampling cost "
    "exceeded its budget share (default 1%) of the period — the "
    "profiler refusing to become the hotspot it exists to find. A "
    "climbing value means the process has too many/too-deep threads "
    "for the configured -profile cadence.",
)

# -- GC observability (obs/profiler.py gc.callbacks hook) --------------------

GC_PAUSE_SECONDS = _R.histogram(
    "gol_gc_pause_seconds",
    "Stop-the-world garbage-collection pause walls (gc.callbacks "
    "start->stop), metered while the profiler runs. Feeds the "
    "'gc-pause' SLO rule: a pause is wall time no turn-segment "
    "decomposition can name, and past ~50 ms it IS the p99.",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
)
GC_COLLECTIONS_TOTAL = _R.counter(
    "gol_gc_collections_total",
    "Garbage-collection passes by generation ('0'/'1'/'2'), metered "
    "while the profiler runs. A hot gen-2 rate alongside gc-pause "
    "spikes usually means a reference-cycle churn in the serving path.",
    labelnames=("gen",),
)

# -- fleet collector (obs/fleet.py) -------------------------------------------
# Published only inside the COLLECTOR process (its own registry, its own
# Status verb): scrape health and merge cost of the control plane itself,
# kept off every data-plane process's registry by construction — the
# registrations below run lazily, on ``obs.fleet`` import, so a broker's
# or worker's Status payload never carries the fleet families' (empty)
# series and help text. The incremental-reply size budget
# (tests/test_tenants.py) counts every registered family.

FLEET_SCRAPES_TOTAL = None
FLEET_TARGETS_TOTAL = None
FLEET_TARGETS_DOWN = None
FLEET_SCRAPE_SECONDS = None
FLEET_MERGE_FAILURES_TOTAL = None
FLEET_SESSIONS_ACTIVE = None
FLEET_CAPACITY_TOTAL = None
FLEET_TENANT_SKEW = None


def register_fleet_instruments() -> None:
    """Register the gol_fleet_* families (idempotent — the registry
    refuses only signature CHANGES). obs/fleet.py calls this at import,
    the only module that publishes these series."""
    global FLEET_SCRAPES_TOTAL, FLEET_TARGETS_TOTAL, FLEET_TARGETS_DOWN
    global FLEET_SCRAPE_SECONDS, FLEET_MERGE_FAILURES_TOTAL
    global FLEET_SESSIONS_ACTIVE, FLEET_CAPACITY_TOTAL, FLEET_TENANT_SKEW
    FLEET_SCRAPES_TOTAL = _R.counter(
        "gol_fleet_scrapes_total",
        "Per-target Status scrape attempts by the fleet collector "
        "(obs/fleet.py), by outcome: 'ok' for a payload, 'error' for a "
        "timeout/refused/skew failure. The error rate per address is the "
        "scrape-health signal fleet doctor findings cite as evidence.",
        labelnames=("outcome",),
    )
    FLEET_TARGETS_TOTAL = _R.gauge(
        "gol_fleet_targets_total",
        "Targets the collector currently scrapes (configured brokers plus "
        "workers auto-discovered from their worker_health rosters).",
    )
    FLEET_TARGETS_DOWN = _R.gauge(
        "gol_fleet_targets_down",
        "Targets currently marked STALE: consecutive scrape failures pushed "
        "the last-success age past the staleness bound (3 intervals). The "
        "'target-down' fleet SLO rule pages on this going nonzero — a dead "
        "broker is a first-class finding, not a timeout traceback.",
    )
    FLEET_SCRAPE_SECONDS = _R.histogram(
        "gol_fleet_scrape_seconds",
        "Wall seconds per fleet poll sweep (parallel fan-out across all "
        "targets + exact merge + fleet timeline sample). bench.py embeds "
        "its p99 as fleet_scrape_p99_us and gates the data-plane tax of "
        "being scraped at <=2% beyond the noise band.",
    )
    FLEET_MERGE_FAILURES_TOTAL = _R.counter(
        "gol_fleet_merge_failures_total",
        "Target snapshots EXCLUDED from the merged cluster registry because "
        "merge_snapshots refused them (type or histogram-edge mismatch — "
        "version skew across the fleet). Skew degrades loudly, never "
        "wrongly: the exactness contract means a non-mergeable snapshot is "
        "dropped and counted, not averaged in.",
    )
    FLEET_SESSIONS_ACTIVE = _R.gauge(
        "gol_fleet_sessions_active",
        "Sum of gol_sessions_active across all live broker targets — the "
        "numerator of the fleet capacity-headroom rule (denominator: summed "
        "session_capacity from each broker's Status).",
    )
    FLEET_CAPACITY_TOTAL = _R.gauge(
        "gol_fleet_capacity_total",
        "Sum of session_capacity across all live broker targets. 0 while no "
        "broker has reported (keeps the headroom rule silent rather than "
        "dividing by a lie).",
    )
    FLEET_TENANT_SKEW = _R.gauge(
        "gol_fleet_tenant_skew",
        "Worst cross-broker tenant skew from the merged ledgers: for each "
        "tenant, its hottest broker's share of that tenant's fleet "
        "device-seconds, times the broker count (1.0 = perfectly spread, "
        "N = all load on one broker). Only computed once >=2 brokers ship "
        "ledgers; the 'fleet-tenant-skew' rule warns past 3x fair share.",
    )

# -- lock sanitizer (utils/locksan.py) ---------------------------------------

LOCKSAN_VIOLATIONS_TOTAL = _R.counter(
    "gol_locksan_violations_total",
    "Lock-sanitizer incidents under GOL_LOCKSAN=1 (utils/locksan.py), "
    "by kind: 'order' for an observed acquisition inverting the "
    "recorded lock order (the acquiring thread also aborts with both "
    "stacks), 'watchdog' for a lock held past GOL_LOCKSAN_DEADLINE "
    "with waiters queued (all-thread tracebacks dumped to "
    "out/locksan_<ts>.txt). Always 0 in production: the wrappers are "
    "never installed without the env knob.",
    labelnames=("kind",),
)
