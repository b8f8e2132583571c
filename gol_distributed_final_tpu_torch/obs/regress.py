"""Noise-aware bench diff — the perf-regression gate over BENCH JSON.

    python -m gol_distributed_final_tpu_torch.obs.regress BENCH_r04.json BENCH_r05.json
    python -m gol_distributed_final_tpu_torch.obs.regress --latest
    scripts/bench_diff A.json B.json          # the same thing

Compares two bench outputs case-by-case using each case's OWN recorded
noise: ``bench.py``'s marginal fit stores the min-estimator endpoint
spread (``spread_s``) and the endpoint distance (``n_hi - n_lo``), so the
per-turn uncertainty of each measurement is ``spread_s / (n_hi - n_lo)``
— the same quantity the bench's NOISE_MARGIN publication gate is built
on. A delta between two rounds is only a verdict when it exceeds the
COMBINED noise of both sides (scaled by ``--noise-k``); inside that band
it is ``jitter`` regardless of how large the percentage looks. Past the
noise band, a slowdown must also exceed ``--threshold`` (relative) to be
``REGRESSED`` — the nonzero-exit verdict ``scripts/check --bench-diff``
enforces in CI.

Inputs, per file (auto-detected):

* bench.py's own JSON line (``{"metric": ..., "extra": {cases...}}``);
* the driver wrapper (``{"n", "cmd", "rc", "tail", "parsed"}``) around a
  BENCH_r*.json round. The wrapper's ``tail`` keeps only the last 2000
  characters of stdout, which can cut the JSON line's HEAD off — the
  loader then SALVAGES every complete per-case object out of the
  truncated text (case dicts are flat, so balanced-brace extraction is
  exact) and reports how many cases survived.

Verdicts per case: ``REGRESSED`` (the only one that fails the gate),
``slower``, ``jitter``, ``faster``, ``improved``, ``new``, ``removed``,
and ``incomparable`` (a side without a usable per-turn fit).

Environment provenance: bench.py stamps ``jax.__version__``, device
kind/count, and the git SHA into its line; when both sides carry it and
the jax version or device fleet differ, the comparison REFUSES (exit 2)
unless ``--force`` — a number from a different chip is not a regression.

No jax import — runnable anywhere, including the lint-only CI leg.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys
from typing import Dict, List, Optional, Tuple

# provenance keys that must agree for per-turn times to be comparable
_PROVENANCE_KEYS = ("jax_version", "device_kind", "device_count")

# a complete flat JSON object assigned to a quoted key: the salvage unit
_CASE_RE = re.compile(r'"(\w+)":\s*(\{[^{}]*\})')


class BenchLoadError(RuntimeError):
    """The file held nothing comparable (not even salvageable cases)."""


def _cases_from_extra(extra: dict) -> Dict[str, dict]:
    """The measurement cases of a bench line: every extra entry that is a
    dict carrying a marginal fit (stage_timings etc. filter out)."""
    return {
        name: case
        for name, case in extra.items()
        if isinstance(case, dict) and "per_turn_us" in case
    }


def _find_bench_line(text: str) -> Optional[dict]:
    """The first parseable bench JSON line (``{"metric": ...}``) among the
    lines of a stdout capture, or None — shared by the raw-capture and
    driver-wrapper loaders so their line detection cannot drift."""
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{") and '"metric"' in line:
            try:
                return json.loads(line)
            except ValueError:
                continue
    return None


def _salvage_cases(text: str) -> Dict[str, dict]:
    """Every complete ``"name": {...}`` case object in a (possibly
    head-truncated) text — the driver wrapper keeps only the tail of
    stdout, so the bench line's opening may be gone while most case
    objects survive intact."""
    out: Dict[str, dict] = {}
    for name, body in _CASE_RE.findall(text):
        try:
            case = json.loads(body)
        except ValueError:
            continue
        if isinstance(case, dict) and "per_turn_us" in case:
            out[name] = case
    return out


def load_bench(path) -> dict:
    """Read one bench output file into ``{label, cases, provenance,
    salvaged}``. Accepts bench.py's own JSON line or the driver wrapper
    (salvaging from a truncated tail when needed)."""
    path = pathlib.Path(path)
    text = path.read_text()
    try:
        doc = json.loads(text)
    except ValueError:
        # raw stdout capture: find the bench line among the lines
        doc = _find_bench_line(text)
    result = {
        "label": path.name,
        "cases": {},
        "provenance": None,
        "salvaged": False,
    }
    if isinstance(doc, dict) and "extra" in doc:
        result["cases"] = _cases_from_extra(doc.get("extra") or {})
        result["provenance"] = doc.get("provenance")
        return result
    if isinstance(doc, dict) and "tail" in doc:
        # driver wrapper: prefer a parsed payload if the driver kept one
        parsed = doc.get("parsed")
        if isinstance(parsed, dict) and "extra" in parsed:
            result["cases"] = _cases_from_extra(parsed.get("extra") or {})
            result["provenance"] = parsed.get("provenance")
            return result
        tail = doc.get("tail") or ""
        line_match = _find_bench_line(tail)
        if isinstance(line_match, dict) and "extra" in line_match:
            result["cases"] = _cases_from_extra(line_match.get("extra") or {})
            result["provenance"] = line_match.get("provenance")
            return result
        result["cases"] = _salvage_cases(tail)
        result["salvaged"] = True
        if result["cases"]:
            return result
    if isinstance(doc, dict):
        # a bare extra-shaped dict (the test fixture form)
        cases = _cases_from_extra(doc)
        if cases:
            result["cases"] = cases
            return result
    # last resort: salvage from the raw text
    result["cases"] = _salvage_cases(text)
    result["salvaged"] = True
    if result["cases"]:
        return result
    raise BenchLoadError(f"{path}: no bench cases found (even by salvage)")


def _per_turn_noise_us(case: dict, noise_k: float) -> Optional[float]:
    """One side's per-turn uncertainty in µs: the min-estimator endpoint
    spread divided over the marginal turn distance, scaled by noise_k.
    None when the case predates the spread fields (old rounds)."""
    spread = case.get("spread_s")
    n_lo, n_hi = case.get("n_lo"), case.get("n_hi")
    if spread is None or not n_lo or not n_hi or n_hi <= n_lo:
        return None
    return noise_k * spread * 1e6 / (n_hi - n_lo)


def compare_case(
    old: Optional[dict],
    new: Optional[dict],
    *,
    threshold: float = 0.05,
    noise_k: float = 2.0,
) -> dict:
    """One case's verdict: ``REGRESSED`` / ``slower`` / ``faster`` /
    ``improved`` / ``jitter`` / ``new`` / ``removed`` / ``incomparable``
    (a side present but without a usable per_turn_us — e.g. a zero or
    missing fit on a salvaged fragment; reported, never gating).

    The delta must clear the combined per-turn noise of BOTH sides to be
    a verdict at all (inside: ``jitter``); a slowdown past the noise must
    also exceed ``threshold`` relative to the old time to be the gating
    ``REGRESSED`` (between: ``slower``, reported but not failing)."""
    if old is None:
        return {"verdict": "new", "new_us": new.get("per_turn_us")}
    if new is None:
        return {"verdict": "removed", "old_us": old.get("per_turn_us")}
    old_us, new_us = old.get("per_turn_us"), new.get("per_turn_us")
    out = {"old_us": old_us, "new_us": new_us}
    # symmetric: a zero/missing fit on EITHER side is a broken
    # measurement, never an infinite improvement or regression. The byte
    # gate still applies below: byte accounting survives a broken
    # wall-clock fit (e.g. a salvaged round), and a deterministic comms
    # regression must not hide behind an unusable timing.
    if not old_us or not new_us:
        out["verdict"] = "incomparable"
        out = _apply_roofline_gate(old, new, out, threshold, 0.0)
        out = _apply_sparse_gates(old, new, out, threshold, 0.0)
        out = _apply_fused_gate(old, new, out, threshold)
        out = _apply_journal_gate(old, new, out, threshold)
        out = _apply_profile_gate(old, new, out, threshold)
        out = _apply_fleet_gate(old, new, out, threshold)
        out = _apply_wire_bytes_gate(old, new, out, threshold)
        return _apply_halo_bytes_gate(old, new, out, threshold)
    delta = new_us - old_us
    rel = delta / old_us
    noises = [
        n
        for n in (
            _per_turn_noise_us(old, noise_k),
            _per_turn_noise_us(new, noise_k),
        )
        if n is not None
    ]
    noise_us = sum(noises) if noises else 0.0
    out["delta_pct"] = 100.0 * rel
    out["noise_pct"] = 100.0 * noise_us / old_us
    if abs(delta) <= noise_us:
        out["verdict"] = "jitter"
    elif delta > 0:
        out["verdict"] = "REGRESSED" if rel > threshold else "slower"
    else:
        out["verdict"] = "improved" if -rel > threshold else "faster"
    out = _apply_roofline_gate(old, new, out, threshold, noise_us / old_us)
    out = _apply_sparse_gates(old, new, out, threshold, noise_us / old_us)
    out = _apply_fused_gate(old, new, out, threshold)
    out = _apply_journal_gate(old, new, out, threshold)
    out = _apply_profile_gate(old, new, out, threshold)
    out = _apply_fleet_gate(old, new, out, threshold)
    out = _apply_wire_bytes_gate(old, new, out, threshold)
    return _apply_halo_bytes_gate(old, new, out, threshold)


def _apply_roofline_gate(
    old: dict, new: dict, out: dict, threshold: float, noise_rel: float
) -> dict:
    """The achieved-throughput gate (obs/perf.py roofline fields embedded
    per kernel case from bench.py): a per-SITE drop in achieved FLOP/s
    past the threshold AND the noise band is REGRESSED in its own units.
    HONESTY NOTE: while both rounds' fields come from the analytic cost
    model over the same case's fit (the current bench), this is
    mathematically redundant with the wall-clock gate (flops ∝ 1/wall,
    same constant) — it becomes load-bearing when the sides' throughput
    sources diverge: a future bench embedding MEASURED dispatch-stats
    throughput, a model-constant change between rounds, or a salvaged
    side whose wall-clock fit broke but whose embedded fields survived.
    A bound-class flip (e.g. memory-bound -> launch-bound) is always
    REPORTED; it only gates when the throughput drop does (a class is a
    coarse call and a flip alone can be a utilization hovering at the
    boundary)."""
    old_f, new_f = old.get("achieved_flops"), new.get("achieved_flops")
    if old_f and new_f:
        drop_rel = (old_f - new_f) / old_f
        out["old_achieved_flops"] = old_f
        out["new_achieved_flops"] = new_f
        out["achieved_delta_pct"] = -100.0 * drop_rel
        if drop_rel > threshold + noise_rel:
            out["verdict"] = "REGRESSED"
            out["why"] = (
                "achieved FLOP/s fell past threshold beyond the noise band"
            )
    old_c, new_c = old.get("bound_class"), new.get("bound_class")
    if old_c and new_c and old_c != new_c:
        out["bound_class_change"] = f"{old_c} -> {new_c}"
    return out


def _apply_sparse_gates(
    old: dict, new: dict, out: dict, threshold: float, noise_rel: float
) -> dict:
    """The activity-sparse gates (ISSUE 14 satellite): per-ACTIVE-cell
    throughput (``cell_updates_per_s_active`` on the sparse-board cases)
    gates like achieved FLOP/s — a drop past threshold AND the noise
    band is REGRESSED in its own units — and delta-sync byte growth
    (``sparse_frame_bytes_per_sync``) gates like wire bytes: byte
    accounting is deterministic, so no noise band applies."""
    old_a, new_a = (
        old.get("cell_updates_per_s_active"),
        new.get("cell_updates_per_s_active"),
    )
    if old_a and new_a:
        drop_rel = (old_a - new_a) / old_a
        out["old_active_updates_per_s"] = old_a
        out["new_active_updates_per_s"] = new_a
        out["active_delta_pct"] = -100.0 * drop_rel
        if drop_rel > threshold + noise_rel:
            out["verdict"] = "REGRESSED"
            out["why"] = (
                "per-active-cell throughput fell past threshold beyond "
                "the noise band"
            )
    old_b, new_b = (
        old.get("sparse_frame_bytes_per_sync"),
        new.get("sparse_frame_bytes_per_sync"),
    )
    if old_b and new_b:
        bytes_rel = (new_b - old_b) / old_b
        out["old_sparse_sync_bytes"] = old_b
        out["new_sparse_sync_bytes"] = new_b
        out["sparse_sync_delta_pct"] = 100.0 * bytes_rel
        if bytes_rel > threshold:
            out["verdict"] = "REGRESSED"
            out["why"] = "sparse sync bytes grew past threshold"
    return out


def _apply_fused_gate(
    old: dict, new: dict, out: dict, threshold: float
) -> dict:
    """The launch-floor gate (ISSUE 15 satellite): the fused bench pair
    embeds ``dispatches_per_turn`` (device launches per turn — 1.0 for
    the serial chain, 1/K fused). Launch accounting is DETERMINISTIC
    like byte accounting — no noise band — so growth past the threshold
    gates even when the wall-clock verdict is clean or unusable: a
    routing regression that quietly un-fuses the ladder fails bench_diff
    here, not in a later wall-clock drift."""
    old_d, new_d = old.get("dispatches_per_turn"), new.get("dispatches_per_turn")
    if old_d and new_d:
        rel = (new_d - old_d) / old_d
        out["old_dispatches_per_turn"] = old_d
        out["new_dispatches_per_turn"] = new_d
        out["dispatches_delta_pct"] = 100.0 * rel
        if rel > threshold:
            out["verdict"] = "REGRESSED"
            out["why"] = "dispatches per turn grew past threshold"
    return out


def _apply_journal_gate(
    old: dict, new: dict, out: dict, threshold: float
) -> dict:
    """The journal-cost trajectory gate (ISSUE 16 satellite): the wire
    bench's journal pair embeds ``journal_overhead_pct`` (journal-on vs
    journal-off resident K=8). bench.py's own run-time gate holds each
    round under 2% beyond its noise band; THIS gate is the cross-round
    backstop — overhead creeping up by more than ``100 * threshold``
    percentage points between rounds (default 5 points) is REGRESSED
    even if a loosened or noisy per-round band let it through, so a
    hot-path record() regression cannot ratchet in across rounds."""
    old_j, new_j = old.get("journal_overhead_pct"), new.get("journal_overhead_pct")
    if old_j is not None and new_j is not None:
        out["old_journal_overhead_pct"] = old_j
        out["new_journal_overhead_pct"] = new_j
        out["journal_overhead_delta_pts"] = round(new_j - old_j, 2)
        if new_j - old_j > 100.0 * threshold:
            out["verdict"] = "REGRESSED"
            out["why"] = (
                "journal overhead grew past the cross-round threshold"
            )
    return out


def _apply_profile_gate(
    old: dict, new: dict, out: dict, threshold: float
) -> dict:
    """The profiler-cost trajectory gate (ISSUE 17): the wire bench's
    profiler pair embeds ``profile_overhead_pct`` (profiler-on vs
    profiler-off resident K=8). bench.py's own run-time gate holds each
    round under 2% beyond its noise band; THIS gate is the cross-round
    backstop — sampling overhead creeping up by more than
    ``100 * threshold`` percentage points between rounds is REGRESSED
    even if a loosened per-round band let it through (the journal gate's
    pattern, applied to the sampler's hot path: _extract_stacks and
    _fold). The embedded ``profile_hot`` table (top busy frames with
    ``self_share``) also rides along: the top mover between rounds is
    always REPORTED, and a frame's share growing by more than 0.35
    absolute gates — sampling shares jitter, so only a wholesale shift
    of the profile's center of mass (a new dominant frame) is a verdict,
    not a few points of drift."""
    old_p, new_p = old.get("profile_overhead_pct"), new.get("profile_overhead_pct")
    if old_p is not None and new_p is not None:
        out["old_profile_overhead_pct"] = old_p
        out["new_profile_overhead_pct"] = new_p
        out["profile_overhead_delta_pts"] = round(new_p - old_p, 2)
        if new_p - old_p > 100.0 * threshold:
            out["verdict"] = "REGRESSED"
            out["why"] = (
                "profiler overhead grew past the cross-round threshold"
            )
    old_h, new_h = old.get("profile_hot"), new.get("profile_hot")
    if isinstance(old_h, list) and isinstance(new_h, list) and new_h:
        shares_old = {
            r.get("frame"): r.get("self_share") or 0.0
            for r in old_h if isinstance(r, dict)
        }
        movers = sorted(
            (
                (
                    (r.get("self_share") or 0.0)
                    - shares_old.get(r.get("frame"), 0.0),
                    str(r.get("frame")),
                )
                for r in new_h
                if isinstance(r, dict) and r.get("frame")
            ),
            reverse=True,
        )
        if movers:
            delta_share, frame = movers[0]
            out["profile_top_mover"] = frame
            out["profile_top_mover_delta_share"] = round(delta_share, 3)
            if delta_share > 0.35:
                out["verdict"] = "REGRESSED"
                out["why"] = (
                    "the profile's dominant frame shifted between rounds"
                )
    return out


def _apply_fleet_gate(
    old: dict, new: dict, out: dict, threshold: float
) -> dict:
    """The fleet scrape-tax trajectory gate (ISSUE 18 satellite): the
    wire bench's collector pair embeds ``fleet_overhead_pct``
    (collector-on vs collector-off resident K=8, a FleetCollector
    sweeping the workers at a 1 s cadence). bench.py's own run-time
    gate holds each round under 2% beyond its noise band; THIS gate is
    the cross-round backstop — the data-plane tax of being scraped
    creeping up by more than ``100 * threshold`` percentage points
    between rounds is REGRESSED even if a loosened per-round band let it
    through (the journal/profiler gates' pattern, applied to the Status
    serve path + the collector's fan-out). The embedded
    ``fleet_scrape_p99_us`` (p99 of gol_fleet_scrape_seconds) rides
    along as REPORTED context — sweep latency is the collector's own
    cost, already bounded by its cadence, so it informs but never
    gates."""
    old_f, new_f = old.get("fleet_overhead_pct"), new.get("fleet_overhead_pct")
    if old_f is not None and new_f is not None:
        out["old_fleet_overhead_pct"] = old_f
        out["new_fleet_overhead_pct"] = new_f
        out["fleet_overhead_delta_pts"] = round(new_f - old_f, 2)
        if new_f - old_f > 100.0 * threshold:
            out["verdict"] = "REGRESSED"
            out["why"] = (
                "fleet scrape tax grew past the cross-round threshold"
            )
    old_p, new_p = old.get("fleet_scrape_p99_us"), new.get("fleet_scrape_p99_us")
    if old_p is not None and new_p is not None:
        out["old_fleet_scrape_p99_us"] = old_p
        out["new_fleet_scrape_p99_us"] = new_p
    return out


def _apply_wire_bytes_gate(
    old: dict, new: dict, out: dict, threshold: float
) -> dict:
    """The comms meter rides along on wire-mode cases
    (``wire_bytes_per_turn`` from gol_wire_bytes_total): byte accounting
    is deterministic — no noise band — so growth past the threshold gates
    even when the wall-clock verdict was clean OR unusable. The comms win
    is a contract, not a side effect."""
    old_b, new_b = old.get("wire_bytes_per_turn"), new.get("wire_bytes_per_turn")
    if old_b and new_b:
        bytes_rel = (new_b - old_b) / old_b
        out["old_bytes"] = old_b
        out["new_bytes"] = new_b
        out["bytes_delta_pct"] = 100.0 * bytes_rel
        if bytes_rel > threshold:
            out["verdict"] = "REGRESSED"
            out["why"] = "wire bytes/turn grew past threshold"
    return out


def _apply_halo_bytes_gate(
    old: dict, new: dict, out: dict, threshold: float
) -> dict:
    """The wire-bytes gate's resident-halo twin: tile/strip bench cases
    embed ``halo_bytes_per_turn`` (gol_halo_bytes_total summed over
    axes), and halo accounting is exactly as deterministic — a change
    that quietly grows the halo cone (wider bands, unpacked corners, a
    worse layout) gates here even when wall-clock looks fine."""
    old_b, new_b = old.get("halo_bytes_per_turn"), new.get("halo_bytes_per_turn")
    if old_b and new_b:
        halo_rel = (new_b - old_b) / old_b
        out["old_halo_bytes"] = old_b
        out["new_halo_bytes"] = new_b
        out["halo_bytes_delta_pct"] = 100.0 * halo_rel
        if halo_rel > threshold:
            out["verdict"] = "REGRESSED"
            out["why"] = "halo bytes/turn grew past threshold"
    return out


def compare(
    old: dict, new: dict, *, threshold: float = 0.05, noise_k: float = 2.0
) -> Dict[str, dict]:
    """Per-case verdicts over the union of both sides' case names."""
    names = sorted(set(old["cases"]) | set(new["cases"]))
    return {
        name: compare_case(
            old["cases"].get(name),
            new["cases"].get(name),
            threshold=threshold,
            noise_k=noise_k,
        )
        for name in names
    }


def provenance_conflicts(old: dict, new: dict) -> List[str]:
    """Human-readable mismatches between two provenance stamps; empty when
    compatible or when either side predates provenance stamping."""
    a, b = old.get("provenance"), new.get("provenance")
    if not a or not b:
        return []
    out = []
    for key in _PROVENANCE_KEYS:
        va, vb = a.get(key), b.get(key)
        if va is not None and vb is not None and va != vb:
            out.append(f"{key}: {va!r} vs {vb!r}")
    return out


def _fmt_us(v) -> str:
    return f"{v:.5f}" if isinstance(v, (int, float)) else "-"


def render_table(verdicts: Dict[str, dict]) -> str:
    header = (
        f"{'case':<28} {'old µs/t':>10} {'new µs/t':>10} "
        f"{'Δ%':>8} {'noise±%':>8}  verdict"
    )
    lines = [header, "-" * len(header)]
    for name, v in verdicts.items():
        delta = v.get("delta_pct")
        noise = v.get("noise_pct")
        tail = v["verdict"]
        if v.get("bound_class_change"):
            tail += f"  [{v['bound_class_change']}]"
        lines.append(
            f"{name:<28} {_fmt_us(v.get('old_us')):>10} "
            f"{_fmt_us(v.get('new_us')):>10} "
            f"{(f'{delta:+.1f}' if delta is not None else '-'):>8} "
            f"{(f'{noise:.1f}' if noise is not None else '-'):>8}  "
            f"{tail}"
        )
    return "\n".join(lines)


# a bench ROUND and nothing else: MULTICHIP_r*.json and friends share the
# _r<N>.json suffix and a lax pattern would sort them into the rounds —
# the exact-name match is the selection contract (test-pinned)
_ROUND_RE = re.compile(r"^BENCH_r(\d+)\.json$")


def latest_bench_files(directory=".") -> List[pathlib.Path]:
    """The BENCH_r*.json rounds of a repo, oldest to newest by round
    number (lexical sort breaks at r10 without the numeric key).
    STRICTLY ``BENCH_r<number>.json``: other result files in the same
    directory (``MULTICHIP_r*.json``, a stray ``BENCH_rX.json``) are
    ignored, never sorted into the rounds ``--latest`` gates on."""
    out = []
    for p in pathlib.Path(directory).glob("BENCH_r*.json"):
        m = _ROUND_RE.match(p.name)
        if m:
            out.append((int(m.group(1)), p))
    return [p for _, p in sorted(out)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="noise-aware diff of two bench JSON outputs "
        "(nonzero exit on a regression past the threshold)"
    )
    parser.add_argument(
        "files", nargs="*", metavar="JSON",
        help="OLD.json NEW.json (bench.py line or driver BENCH_r*.json)",
    )
    parser.add_argument(
        "--latest", action="store_true",
        help="compare the two newest BENCH_r*.json in --dir instead of "
             "naming files (no-op exit 0 when fewer than two exist)",
    )
    parser.add_argument("--dir", default=".", help="where --latest looks")
    parser.add_argument(
        "--threshold", type=float, default=0.05, metavar="FRAC",
        help="relative slowdown past the noise band that fails the gate "
             "(default 0.05 = 5%%)",
    )
    parser.add_argument(
        "--noise-k", type=float, default=2.0, metavar="K",
        help="noise-band scale: delta must exceed K x (old + new per-turn "
             "spread) to be a verdict at all (default 2)",
    )
    parser.add_argument(
        "--force", action="store_true",
        help="compare despite a provenance mismatch (different jax / "
             "device fleet)",
    )
    args = parser.parse_args(argv)

    if args.latest:
        rounds = latest_bench_files(args.dir)
        if len(rounds) < 2:
            print(
                f"bench-diff: fewer than two BENCH_r*.json in {args.dir!r} "
                "— nothing to gate", file=sys.stderr,
            )
            return 0
        old_path, new_path = rounds[-2], rounds[-1]
    elif len(args.files) == 2:
        old_path, new_path = args.files
    else:
        parser.error("need OLD.json NEW.json, or --latest")

    try:
        old, new = load_bench(old_path), load_bench(new_path)
    except (OSError, BenchLoadError) as exc:
        print(f"bench-diff: {exc}", file=sys.stderr)
        return 2

    for side in (old, new):
        if side["salvaged"]:
            print(
                f"note: {side['label']} was salvaged from a truncated "
                f"tail — {len(side['cases'])} case(s) recovered, "
                "provenance unknown", file=sys.stderr,
            )
    conflicts = provenance_conflicts(old, new)
    if conflicts:
        msg = (
            f"provenance mismatch between {old['label']} and "
            f"{new['label']}: " + "; ".join(conflicts)
        )
        if not args.force:
            print(
                f"bench-diff: REFUSING to compare — {msg} (use --force "
                "to override)", file=sys.stderr,
            )
            return 2
        print(f"warning: {msg} (forced)", file=sys.stderr)
    elif not (old.get("provenance") and new.get("provenance")):
        print(
            "note: provenance absent on at least one side (pre-stamping "
            "round) — environment compatibility unverified", file=sys.stderr,
        )

    verdicts = compare(
        old, new, threshold=args.threshold, noise_k=args.noise_k
    )
    print(f"bench diff: {old['label']} -> {new['label']}")
    print(render_table(verdicts))
    regressed = [n for n, v in verdicts.items() if v["verdict"] == "REGRESSED"]
    if regressed:
        print(
            f"\nFAIL: {len(regressed)} case(s) regressed past "
            f"{100 * args.threshold:.0f}% beyond noise: "
            + ", ".join(regressed)
        )
        return 1
    print("\nok: no regression beyond the noise band and threshold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
