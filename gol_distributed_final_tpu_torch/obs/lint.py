"""Name lints: the code's registries and the README's tables must agree.

Two operator-facing name contracts live in this package: metric names
(``obs/instruments.py`` — RunReports, Status payloads, Prometheus scrapes)
and span names (``obs/tracing.py`` — Chrome trace exports, flight-recorder
events). The README "Observability" and "Tracing" sections are their
documentation of record; the device-telemetry families (obs/device.py)
additionally must sit in the dedicated "Device telemetry" table, and the
operator-facing sections themselves ("Device telemetry", "Perf regression
gate", ...) must exist. These lints fail when a name registered in code
is missing from the README — so adding an instrument or a span site
without documenting it breaks the build (``tests/test_obs.py`` and
``tests/test_tracing.py`` run them;
``python -m gol_distributed_final_tpu_torch.obs.lint`` and the ``scripts/check``
wrapper run them standalone, outside pytest).
"""

from __future__ import annotations

import pathlib
import sys
from typing import List

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


def undocumented_metrics(readme_path=None, histograms_only: bool = False) -> List[str]:
    """Names registered in code but absent from the README text."""
    from . import instruments  # noqa: F401 - registers every family
    from .metrics import registry

    if readme_path is None:
        readme_path = REPO_ROOT / "README.md"
    text = pathlib.Path(readme_path).read_text()
    missing = []
    for fam in registry().families():
        if histograms_only and fam.kind != "histogram":
            continue
        if fam.name not in text:
            missing.append(fam.name)
    return sorted(missing)


def undocumented_spans(readme_path=None) -> List[str]:
    """Span names declared in obs/tracing.py but absent from the README."""
    from .tracing import registered_span_names

    if readme_path is None:
        readme_path = REPO_ROOT / "README.md"
    text = pathlib.Path(readme_path).read_text()
    return sorted(n for n in registered_span_names() if n not in text)


# prefixes of the device-telemetry metric families (obs/device.py): these
# must be documented in the README's dedicated "Device telemetry" table,
# not just anywhere in the file (gol_compile_cache_* predates obs/device
# and lives in the main Observability table)
_DEVICE_METRIC_PREFIXES = (
    "gol_compile_seconds", "gol_kernel_", "gol_device_hbm_",
)

# operator-facing sections the README must keep: the doc anchors the name
# lints point at, and the regression-gate/watch docs this package's CLIs
# reference in their own help text
_REQUIRED_SECTIONS = (
    "## Observability",
    "## Tracing",
    "Device telemetry",
    "Perf regression gate",
    "Fault tolerance",
    "Wire modes",
    # the 2-D checkerboard tile plane (-grid, rpc/broker._tile_turn_loop):
    # grid knobs, the corner-halo cost table, the fault/attestation
    # contract, and the halo-depth/sync-interval/sparse-sync interactions
    "## 2-D tiles",
    "Integrity",
    "Sessions",
    "SLOs & alerting",
    "## Doctor",
    # the analysis/ checker suite's operator contract: checker table,
    # suppression syntax, how to add a checker (lint-enforced like the
    # metric tables — analysis/lints.py checks the checker ids are IN it)
    "## Static analysis",
    # the tenant-attribution contract (obs/accounting.py): the session-tag
    # packing convention, the top-K cardinality bound, the Status payload
    # size budget, and the reconciliation guarantees
    "## Accounting & capacity",
    # the blackbox measurement surface (obs/canary.py + obs/loadgen.py):
    # probe verbs, metric tables, loadgen CLI examples
    "## Canary & load harness",
    # the roofline/straggler attribution contract (obs/perf.py +
    # obs/critical.py): metric table, bound-class semantics, CLI
    # examples, and the honest calibration caveats
    "## Performance attribution",
    # the activity-sparse stepping contract (ops/sparse.py + the
    # dirty-tile wire/checkpoint deltas): the activity invariant, the
    # density crossover, the delta-frame format, the early-exit
    # contract, and the knobs
    "## Sparse stepping",
    # the fused K-turns-per-launch contract (ops/fused.py + the engine
    # chunk driver + the worker strip paths): the K/VMEM trade-off
    # table, the routing knobs, and the launch-amortisation metric pair
    "## Fused stepping",
    # the durable lifecycle journal contract (obs/journal.py +
    # obs/history.py): the event-kind table, the HLC semantics, the
    # retention knobs, and the history CLI examples
    "## Journal & history",
    # the continuous-profiler contract (obs/profiler.py + obs/flame.py):
    # the cadence/backoff knobs, overhead budget, artifact formats
    # (collapsed + speedscope), flame diff semantics, and the GC pause
    # meter feeding the gc-pause SLO rule
    "## Profiling",
    # the fleet-collector contract (obs/fleet.py): the collector CLI,
    # scrape/staleness semantics, the fleet rule table, and the
    # gol_fleet_* metric table
    "## Fleet",
)

# the wire data-plane metric families (rpc/protocol.py frames + the
# workers-backend wire modes): these must be documented in the README's
# "Wire modes" section specifically — they are the contract the wire-mode
# bench cases embed and scripts/bench_diff gates
_WIRE_METRIC_NAMES = (
    "gol_wire_bytes_total", "gol_turn_batch_size", "gol_strip_resync_total",
)


def _readme_section(readme_path, anchor: str) -> str:
    """The README text from ``anchor`` to the next top-level heading —
    the section-scoped lint surface: a name that only appears in a LATER
    section must still be flagged. Anchor on the heading itself (e.g.
    ``"## Wire modes"``) when cross-references elsewhere in the file
    could shadow the real section. Missing anchor -> empty section, so
    every required name is reported rather than silently passed."""
    if readme_path is None:
        readme_path = REPO_ROOT / "README.md"
    text = pathlib.Path(readme_path).read_text()
    start = text.find(anchor)
    if start < 0:
        return ""
    end = text.find("\n## ", start)
    return text[start:] if end < 0 else text[start:end]


def undocumented_device_metrics(readme_path=None) -> List[str]:
    """Device-telemetry metric names (obs/device.py's families) missing
    from the README's "Device telemetry" section specifically — a name
    mentioned elsewhere in the file does not count as documented here."""
    from . import instruments  # noqa: F401 - registers every family
    from .metrics import registry

    section = _readme_section(readme_path, "Device telemetry")
    return sorted(
        fam.name
        for fam in registry().families()
        if fam.name.startswith(_DEVICE_METRIC_PREFIXES)
        and fam.name not in section
    )


# the integrity metric families (rpc/integrity.py: checked frames,
# resident-strip attestation, verified checkpoints): these must be
# documented in the README's "Integrity" section specifically — the
# operator contract for the silent-corruption detection surface
_INTEGRITY_METRIC_NAMES = (
    "gol_integrity_checks_total",
    "gol_integrity_failures_total",
    "gol_ckpt_verify_total",
)


def undocumented_integrity_metrics(readme_path=None) -> List[str]:
    """Integrity metric names missing from the README's "Integrity"
    section specifically (the wire/device-table posture: a name mentioned
    elsewhere in the file does not count as documented here)."""
    section = _readme_section(readme_path, "## Integrity")
    return sorted(n for n in _INTEGRITY_METRIC_NAMES if n not in section)


# the multi-universe serving metric families (engine/sessions.py +
# rpc/broker.SessionScheduler): these must be documented in the README's
# "Sessions" section specifically — the operator contract for the
# batched serving surface (admission control, capacity refusals)
_SESSION_METRIC_NAMES = (
    "gol_sessions_active",
    "gol_sessions_admitted_total",
    "gol_sessions_rejected_total",
    "gol_session_turns_total",
)


def undocumented_session_metrics(readme_path=None) -> List[str]:
    """Session metric names missing from the README's "Sessions" section
    specifically (the wire/device-table posture: a name mentioned
    elsewhere in the file does not count as documented here)."""
    section = _readme_section(readme_path, "## Sessions")
    return sorted(n for n in _SESSION_METRIC_NAMES if n not in section)


def undocumented_wire_metrics(readme_path=None) -> List[str]:
    """Wire data-plane metric names missing from the README's
    "Wire modes" section specifically (the device-table posture: a name
    mentioned elsewhere in the file does not count as documented here)."""
    section = _readme_section(readme_path, "## Wire modes")
    return sorted(n for n in _WIRE_METRIC_NAMES if n not in section)


# the 2-D tile data plane's operator names (rpc/broker.py -grid + the
# tile-resident wire): the per-axis halo counter, the layout gauges, and
# the -grid knob itself must be documented in the README's "2-D tiles"
# section specifically — the contract the tile bench pair embeds and the
# regress halo-byte gate enforces
_TILE_DOC_NAMES = (
    "gol_halo_bytes_total",
    "gol_tile_edge_cells",
    "gol_tile_grid_rows",
    "gol_tile_grid_cols",
    "-grid",
)


def undocumented_tile_names(readme_path=None) -> List[str]:
    """Tile data-plane names (metrics + the -grid knob) missing from the
    README's "2-D tiles" section specifically (the wire/device-table
    posture: a name mentioned elsewhere in the file does not count as
    documented here)."""
    section = _readme_section(readme_path, "## 2-D tiles")
    return sorted(n for n in _TILE_DOC_NAMES if n not in section)


# the serving-SLO metric families (obs/timeline.py sampler + obs/slo.py
# rules + their instrument feeds): these must be documented in the
# README's "SLOs & alerting" section specifically — the operator
# contract for the alerting surface
_SLO_METRIC_NAMES = (
    "gol_session_turn_seconds",
    "gol_session_admit_wait_seconds",
    "gol_rpc_dispatch_seconds",
    "gol_scatter_deadline_seconds",
    "gol_slo_alerts_total",
)


def undocumented_slo_metrics(readme_path=None) -> List[str]:
    """SLO metric names missing from the README's "SLOs & alerting"
    section specifically (the wire/device-table posture: a name
    mentioned elsewhere in the file does not count as documented
    here)."""
    section = _readme_section(readme_path, "## SLOs & alerting")
    return sorted(n for n in _SLO_METRIC_NAMES if n not in section)


def undocumented_slo_rules(readme_path=None) -> List[str]:
    """Default SLO rule names (obs/slo.DEFAULT_RULE_NAMES — the stable
    alert-identity contract, the ``gol_slo_alerts_total{rule}`` label
    set) missing from the README's "SLOs & alerting" section."""
    from .slo import DEFAULT_RULE_NAMES

    section = _readme_section(readme_path, "## SLOs & alerting")
    return sorted(n for n in DEFAULT_RULE_NAMES if n not in section)


# the blackbox measurement metric families (obs/canary.py prober +
# obs/loadgen.py generator): these must be documented in the README's
# "Canary & load harness" section specifically — the operator contract
# for the end-to-end correctness probe and the arrival-process harness
_CANARY_METRIC_NAMES = (
    "gol_canary_probes_total",
    "gol_canary_latency_seconds",
    "gol_loadgen_admit_to_first_turn_seconds",
    "gol_loadgen_session_seconds",
    "gol_loadgen_sessions_total",
)


def undocumented_canary_metrics(readme_path=None) -> List[str]:
    """Canary/loadgen metric names missing from the README's "Canary &
    load harness" section specifically (the wire/device-table posture:
    a name mentioned elsewhere does not count as documented here)."""
    section = _readme_section(readme_path, "## Canary & load harness")
    return sorted(n for n in _CANARY_METRIC_NAMES if n not in section)


# the accounting section's contract names: the ledger attributes the
# session meters per tenant, so its section of record must name the
# meters it reconciles against (and the wire field polls echo)
_ACCOUNTING_DOC_NAMES = (
    "gol_sessions_rejected_total",
    "gol_session_turns_total",
    "gol_session_turn_seconds",
    "accounting_since",
)


def undocumented_accounting_names(readme_path=None) -> List[str]:
    """Reconciliation-contract names missing from the README's
    "Accounting & capacity" section specifically."""
    section = _readme_section(readme_path, "## Accounting & capacity")
    return sorted(n for n in _ACCOUNTING_DOC_NAMES if n not in section)


# the performance-attribution metric families (obs/perf.py roofline,
# obs/critical.py straggler, the dispatch-wall decomposition) plus the
# classifier's stable class vocabulary: these must be documented in the
# README's "Performance attribution" section specifically — the contract
# the next perf PR's admission gate reads
_PERF_METRIC_NAMES = (
    "gol_kernel_dispatch_seconds",
    "gol_kernel_achieved_flops",
    "gol_kernel_achieved_bytes_per_s",
    "gol_kernel_bound",
    "gol_turn_segment_seconds",
    "gol_strip_step_seconds",
    "gol_worker_skew_ratio",
    "compute-bound",
    "memory-bound",
    "launch-bound",
)


def undocumented_perf_names(readme_path=None) -> List[str]:
    """Performance-attribution metric/class names missing from the
    README's "Performance attribution" section specifically (the
    wire/device-table posture: a name mentioned elsewhere in the file
    does not count as documented here)."""
    section = _readme_section(readme_path, "## Performance attribution")
    return sorted(n for n in _PERF_METRIC_NAMES if n not in section)


# the activity-sparse metric families (ops/sparse.py, the rpc/ dirty-tile
# deltas, the engine/sessions early exits) plus the contract vocabulary:
# these must be documented in the README's "Sparse stepping" section
# specifically — the operator contract for the frontier/skip/delta/exit
# surface the SPARSITY watch panel renders and bench_diff gates
_SPARSE_DOC_NAMES = (
    "gol_active_tiles",
    "gol_tile_skips_total",
    "gol_sparse_frame_bytes_total",
    "gol_early_exit_total",
    "GOL_SPARSE",
    "-sparse-sync",
)


def undocumented_sparse_names(readme_path=None) -> List[str]:
    """Sparse-stepping metric/knob names missing from the README's
    "Sparse stepping" section specifically (the wire/device-table
    posture: a name mentioned elsewhere in the file does not count as
    documented here)."""
    section = _readme_section(readme_path, "## Sparse stepping")
    return sorted(n for n in _SPARSE_DOC_NAMES if n not in section)


# the fused-stepping contract names (ops/fused.py, the engine's counted
# chunk driver, the worker's skip/fused strip paths): the launch-
# amortisation metric pair, the row-skip meter, and the routing knobs —
# these must be documented in the README's "Fused stepping" section
# specifically, the operator contract bench's fused-vs-serial pair and
# the roofline's fused sites are read against
_FUSED_DOC_NAMES = (
    "gol_fused_launches_total",
    "gol_fused_turns_per_launch",
    "gol_strip_rows_skipped_total",
    "GOL_FUSED",
    "GOL_WORKER_FUSED",
    "-halo-depth",
)


def undocumented_fused_names(readme_path=None) -> List[str]:
    """Fused-stepping metric/knob names missing from the README's
    "Fused stepping" section specifically (the wire/device-table
    posture: a name mentioned elsewhere in the file does not count as
    documented here)."""
    section = _readme_section(readme_path, "## Fused stepping")
    return sorted(n for n in _FUSED_DOC_NAMES if n not in section)


# the durable-journal contract names (obs/journal.py writer +
# obs/history.py merge CLI): the journal meters, the enablement/retention
# knobs, and the incremental Status window field — these must be
# documented in the README's "Journal & history" section specifically,
# the operator contract postmortem reconstruction is read against
_JOURNAL_DOC_NAMES = (
    "gol_journal_events_total",
    "gol_journal_bytes_total",
    "gol_journal_rotations_total",
    "gol_journal_drops_total",
    "-journal",
    "journal_since",
)


def undocumented_journal_names(readme_path=None) -> List[str]:
    """Journal metric/knob names missing from the README's "Journal &
    history" section specifically (the wire/device-table posture: a name
    mentioned elsewhere in the file does not count as documented
    here)."""
    section = _readme_section(readme_path, "## Journal & history")
    return sorted(n for n in _JOURNAL_DOC_NAMES if n not in section)


# the continuous-profiler contract names (obs/profiler.py sampler +
# obs/flame.py render/diff CLI): the sampler meters, the GC pause
# surface, the enablement knob, and the incremental Status window field
# — these must be documented in the README's "Profiling" section
# specifically, the operator contract flame graphs and the doctor's
# hotspot finding are read against
_PROFILER_DOC_NAMES = (
    "gol_profile_samples_total",
    "gol_profile_backoffs_total",
    "gol_gc_pause_seconds",
    "gol_gc_collections_total",
    "-profile",
    "profile_since",
)


def undocumented_profiler_names(readme_path=None) -> List[str]:
    """Profiler metric/knob names missing from the README's "Profiling"
    section specifically (the wire/device-table posture: a name
    mentioned elsewhere in the file does not count as documented
    here)."""
    section = _readme_section(readme_path, "## Profiling")
    return sorted(n for n in _PROFILER_DOC_NAMES if n not in section)


# the fleet-collector contract names (obs/fleet.py): the gol_fleet_*
# metric families, the fleet SLO rule identities (obs/slo.py
# FLEET_RULE_NAMES), and the collector's CLI/staleness knobs — these
# must be documented in the README's "Fleet" section specifically, the
# operator contract the collector's scrape/merge semantics are read
# against
_FLEET_DOC_NAMES = (
    "gol_fleet_scrapes_total",
    "gol_fleet_targets_total",
    "gol_fleet_targets_down",
    "gol_fleet_scrape_seconds",
    "gol_fleet_merge_failures_total",
    "gol_fleet_sessions_active",
    "gol_fleet_capacity_total",
    "gol_fleet_tenant_skew",
    "target-down",
    "fleet-capacity-headroom",
    "fleet-tenant-skew",
    "-interval",
    "-port",
)


def undocumented_fleet_names(readme_path=None) -> List[str]:
    """Fleet metric/rule/knob names missing from the README's "Fleet"
    section specifically (the wire/device-table posture: a name
    mentioned elsewhere in the file does not count as documented
    here)."""
    section = _readme_section(readme_path, "## Fleet")
    return sorted(n for n in _FLEET_DOC_NAMES if n not in section)


def undeclared_journal_kinds(readme_path=None, package_root=None) -> List[str]:
    """Registry drift between the journal's event-kind table and its
    emit sites: every literal kind passed to ``journal.record(...)``
    anywhere in the package must exist in ``obs/journal.EVENT_KINDS``
    (and every event kind the README table documents comes FROM that
    dict, so an undeclared emit is also an undocumented one). Scans
    source text, not imports — an emit site behind an optional dep
    still counts. ``readme_path`` is accepted (and ignored) so the
    analysis wrapper can call every CHECKS entry uniformly."""
    import re

    from .journal import EVENT_KINDS

    if package_root is None:
        package_root = pathlib.Path(__file__).resolve().parent.parent
    pat = re.compile(r"""\b_?journal\.record\(\s*["']([a-z._]+)["']""")
    missing = set()
    for path in sorted(pathlib.Path(package_root).rglob("*.py")):
        try:
            text = path.read_text()
        except OSError:
            continue
        for kind in pat.findall(text):
            if kind not in EVENT_KINDS:
                missing.add(f"{kind} (emitted in {path.name})")
    return sorted(missing)


def missing_readme_sections(readme_path=None) -> List[str]:
    """Required operator-facing README sections that are absent."""
    if readme_path is None:
        readme_path = REPO_ROOT / "README.md"
    text = pathlib.Path(readme_path).read_text()
    return [s for s in _REQUIRED_SECTIONS if s not in text]


# the lint suite, named: ``(check id, function, fail message, ok message)``.
# The ids are the analysis-framework handles — gol_distributed_final_tpu_torch/
# analysis/lints.py re-seats every entry as a repo-level checker under the
# same runner/finding/suppression contract as the AST checkers, so this
# table is the single registry both surfaces share (``scripts/check``
# default + ``--lint`` alias, one behavior).
CHECKS = (
    (
        "lint-metrics",
        undocumented_metrics,
        "metrics registered in obs/instruments.py but missing from "
        "README.md's Observability table:",
        "metric-name lint ok: every registered metric is documented",
    ),
    (
        "lint-spans",
        undocumented_spans,
        "span names declared in obs/tracing.py but missing from "
        "README.md's Tracing table:",
        "span-name lint ok: every declared span name is documented",
    ),
    (
        "lint-device-metrics",
        undocumented_device_metrics,
        "device metrics registered in obs/instruments.py but missing "
        "from README.md's Device telemetry table:",
        "device-metric lint ok: every device metric is in the Device "
        "telemetry table",
    ),
    (
        "lint-wire-metrics",
        undocumented_wire_metrics,
        "wire data-plane metrics missing from README.md's Wire modes "
        "section:",
        "wire-metric lint ok: every wire metric is in the Wire modes "
        "section",
    ),
    (
        "lint-tile-names",
        undocumented_tile_names,
        "tile data-plane names (metrics / the -grid knob) missing from "
        "README.md's 2-D tiles section:",
        "tile-name lint ok: every tile data-plane name is in the "
        "2-D tiles section",
    ),
    (
        "lint-integrity-metrics",
        undocumented_integrity_metrics,
        "integrity metrics missing from README.md's Integrity "
        "section:",
        "integrity-metric lint ok: every integrity metric is in the "
        "Integrity section",
    ),
    (
        "lint-session-metrics",
        undocumented_session_metrics,
        "session metrics missing from README.md's Sessions section:",
        "session-metric lint ok: every session metric is in the "
        "Sessions section",
    ),
    (
        "lint-slo-metrics",
        undocumented_slo_metrics,
        "SLO metrics missing from README.md's SLOs & alerting "
        "section:",
        "slo-metric lint ok: every SLO metric is in the SLOs & "
        "alerting section",
    ),
    (
        "lint-slo-rules",
        undocumented_slo_rules,
        "default SLO rule names missing from README.md's SLOs & "
        "alerting section:",
        "slo-rule lint ok: every default rule name is in the SLOs & "
        "alerting section",
    ),
    (
        "lint-canary-metrics",
        undocumented_canary_metrics,
        "canary/loadgen metrics missing from README.md's Canary & load "
        "harness section:",
        "canary-metric lint ok: every canary/loadgen metric is in the "
        "Canary & load harness section",
    ),
    (
        "lint-accounting-docs",
        undocumented_accounting_names,
        "accounting-contract names missing from README.md's Accounting "
        "& capacity section:",
        "accounting lint ok: the reconciliation contract is documented "
        "in the Accounting & capacity section",
    ),
    (
        "lint-perf-metrics",
        undocumented_perf_names,
        "performance-attribution metric/class names missing from "
        "README.md's Performance attribution section:",
        "perf lint ok: every attribution metric and bound class is in "
        "the Performance attribution section",
    ),
    (
        "lint-sparse-metrics",
        undocumented_sparse_names,
        "sparse-stepping metric/knob names missing from README.md's "
        "Sparse stepping section:",
        "sparse lint ok: every sparse metric and knob is in the Sparse "
        "stepping section",
    ),
    (
        "lint-fused-metrics",
        undocumented_fused_names,
        "fused-stepping metric/knob names missing from README.md's "
        "Fused stepping section:",
        "fused lint ok: every fused metric and knob is in the Fused "
        "stepping section",
    ),
    (
        "lint-journal-metrics",
        undocumented_journal_names,
        "journal metric/knob names missing from README.md's Journal & "
        "history section:",
        "journal lint ok: every journal metric and knob is in the "
        "Journal & history section",
    ),
    (
        "lint-profiler-metrics",
        undocumented_profiler_names,
        "profiler metric/knob names missing from README.md's Profiling "
        "section:",
        "profiler lint ok: every profiler metric and knob is in the "
        "Profiling section",
    ),
    (
        "lint-fleet-metrics",
        undocumented_fleet_names,
        "fleet metric/rule/knob names missing from README.md's Fleet "
        "section:",
        "fleet lint ok: every fleet metric, rule, and knob is in the "
        "Fleet section",
    ),
    (
        "lint-journal-kinds",
        undeclared_journal_kinds,
        "event kinds emitted via journal.record() but missing from "
        "obs/journal.EVENT_KINDS (declare them there AND in the README "
        "table):",
        "journal-kind lint ok: every emitted event kind is declared in "
        "EVENT_KINDS",
    ),
    (
        "lint-sections",
        missing_readme_sections,
        "required README sections missing:",
        "section lint ok: every required README section present",
    ),
)


def main(argv=None) -> int:
    rc = 0
    for _check_id, check, fail_msg, ok_msg in CHECKS:
        missing = check()
        if missing:
            print(fail_msg, file=sys.stderr)
            for name in missing:
                print(f"  {name}", file=sys.stderr)
            rc = 1
        else:
            print(ok_msg)
    return rc


if __name__ == "__main__":
    sys.exit(main())
