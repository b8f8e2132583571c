"""Hot-frame tables, cross-process merges, and profile DIFFS.

    python -m gol_distributed_final_tpu_torch.obs.flame out/profile_run.collapsed
    python -m gol_distributed_final_tpu_torch.obs.flame broker:127.0.0.1:8040 \
        worker:127.0.0.1:8030 worker:127.0.0.1:8031
    python -m gol_distributed_final_tpu_torch.obs.flame -diff \
        out/profile_clean.collapsed out/profile_slow.collapsed
    python -m gol_distributed_final_tpu_torch.obs.flame -diff \
        BENCH_r04.json BENCH_r05.json
    python -m gol_distributed_final_tpu_torch.obs.flame --selfcheck

The render side of obs/profiler.py: every lane the profiler ships
(live Status windows via ``profile_since``, collapsed-stack and
speedscope artifacts, the bench rounds' embedded ``profile_hot``) loads
into one flat shape — frame -> (self hits, cum hits) plus a total — so
tables, merges, and diffs compose across lanes. The diff is the key
tool: frames whose SELF-SHARE of the profile moved more than a noise
threshold between two profiles, regressions first — "what started
eating the wall between these two runs", answered by name.

``--selfcheck`` is the loopback proof the default ``scripts/check``
path runs: spawn a busy-loop subprocess under the profiler, load its
artifact, assert the hot function is named. If the sampler, the trie,
the artifact writer, or this parser breaks, the check names it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

from .profiler import frame_name, is_idle_frame

#: diff noise floor: self-share moves below this many percentage points
#: are sampling jitter, not findings
DEFAULT_NOISE_PP = 0.5
DEFAULT_TOP = 20


def _empty(source: str) -> dict:
    return {"source": source, "total": 0, "frames": {}}


def parse_frame(name: str):
    """Invert profiler.frame_name: ``func (file:line)`` -> parts.
    Unparseable names come back as (name, "", 0) — foreign collapsed
    files still render and diff, they just can't be idle-filtered."""
    if name.endswith(")") and " (" in name:
        func, _, loc = name[:-1].rpartition(" (")
        file, _, line = loc.rpartition(":")
        if line.isdigit():
            return func, file, int(line)
    return name, "", 0


def _frame_idle(name: str) -> bool:
    func, file, _line = parse_frame(name)
    return is_idle_frame(func, file)


def load_collapsed(path, source: Optional[str] = None) -> dict:
    """A collapsed-stack artifact -> the flat shape. The first path
    token is the thread name (profiler.collapsed_lines writes it) and
    is dropped; self lands on the leaf, cum on every unique frame."""
    prof = _empty(source or str(path))
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count_s = line.rpartition(" ")
        try:
            count = int(count_s)
        except ValueError:
            continue
        frames = stack.split(";")[1:]  # [0] is the thread name
        if not frames:
            continue
        prof["total"] += count
        table = prof["frames"]
        for f in dict.fromkeys(frames):
            table.setdefault(f, [0, 0])[1] += count
        table.setdefault(frames[-1], [0, 0])[0] += count
    return prof


def load_speedscope(path, source: Optional[str] = None) -> dict:
    """A speedscope-JSON artifact -> the flat shape (all profiles of
    the file merged — they are this process's threads)."""
    doc = json.loads(pathlib.Path(path).read_text())
    names = [
        frame_name(f.get("name", "?"), f.get("file", ""), f.get("line", 0))
        for f in (doc.get("shared") or {}).get("frames", [])
    ]
    prof = _empty(source or str(path))
    table = prof["frames"]
    for p in doc.get("profiles", []):
        for sample, weight in zip(p.get("samples", []),
                                  p.get("weights", [])):
            if not sample:
                continue
            prof["total"] += weight
            stack = [names[i] for i in sample if 0 <= i < len(names)]
            for f in dict.fromkeys(stack):
                table.setdefault(f, [0, 0])[1] += weight
            if stack:
                table.setdefault(stack[-1], [0, 0])[0] += weight
    return prof


def load_bench_round(path, source: Optional[str] = None) -> dict:
    """A BENCH_r*.json round -> the flat shape, from the profiler
    case's embedded ``profile_hot`` table (``{"frame", "self_share"}``
    rows — bench.py embeds them on the profiler-on wire case).
    Self-shares scale to a synthetic total of 10000 so round-vs-round
    diffs use the same share math as artifact diffs. Reuses the regress
    loader, so driver-wrapped and tail-salvaged rounds load here too."""
    from .regress import load_bench

    prof = _empty(source or str(path))
    for case in load_bench(path)["cases"].values():
        hot = case.get("profile_hot")
        if not isinstance(hot, list) or not hot:
            continue
        prof["total"] = 10000
        for row in hot:
            if not isinstance(row, dict) or "frame" not in row:
                continue
            share = float(row.get("self_share") or 0.0)
            prof["frames"][str(row["frame"])] = [
                int(round(share * 10000)), 0
            ]
        break
    return prof


def load_live(address: str, worker: bool = False,
              timeout: float = 5.0) -> dict:
    """A live process's profile via Status (full window: since=0)."""
    from .status import fetch_status

    payload = fetch_status(
        address, worker=worker, timeout=timeout, profile_since=0
    )
    window = payload.get("profile")
    if not isinstance(window, dict):
        raise RuntimeError(
            f"{address} answered Status but ships no profile window "
            "(started without -profile, or version skew)"
        )
    return from_window(window, source=f"live {address}")


def from_window(window: dict, source: str = "live") -> dict:
    """A Status profile window -> the flat shape."""
    prof = _empty(source)
    prof["total"] = int(window.get("stacks") or 0)
    for row in window.get("frames") or []:
        name = frame_name(
            row.get("func", "?"), row.get("file", ""), row.get("line", 0)
        )
        prof["frames"][name] = [
            int(row.get("self") or 0), int(row.get("cum") or 0)
        ]
    return prof


def load_source(source: str, timeout: float = 5.0) -> dict:
    """One CLI source string -> the flat shape. ``broker:ADDR`` /
    ``worker:ADDR`` poll live; anything else is an artifact path
    (collapsed, speedscope JSON, or a BENCH round)."""
    if source.startswith("broker:"):
        return load_live(source[7:], worker=False, timeout=timeout)
    if source.startswith("worker:"):
        return load_live(source[7:], worker=True, timeout=timeout)
    path = pathlib.Path(source)
    name = path.name
    if name.endswith(".collapsed"):
        return load_collapsed(path)
    if name.startswith("BENCH") and name.endswith(".json"):
        return load_bench_round(path)
    if name.endswith(".json"):
        return load_speedscope(path)
    return load_collapsed(path)


def merge_profiles(profiles: List[dict], source: str = "merged") -> dict:
    """Sum flat profiles — the cross-process view of a cluster run."""
    out = _empty(source)
    out["source"] = ", ".join(p["source"] for p in profiles) or source
    for p in profiles:
        out["total"] += p["total"]
        for name, (s, c) in p["frames"].items():
            row = out["frames"].setdefault(name, [0, 0])
            row[0] += s
            row[1] += c
    return out


def hot_rows(profile: dict, top: int = DEFAULT_TOP,
             active_only: bool = False) -> List[dict]:
    """The table form: hottest self first, shares over the total."""
    total = max(profile["total"], 1)
    rows = [
        {
            "frame": name,
            "self": s,
            "cum": c,
            "self_share": s / total,
            "cum_share": c / total,
            "idle": _frame_idle(name),
        }
        for name, (s, c) in profile["frames"].items()
        if s or c
    ]
    if active_only:
        rows = [r for r in rows if not r["idle"]]
    rows.sort(key=lambda r: (-r["self"], -r["cum"], r["frame"]))
    return rows[:top]


def diff_profiles(old: dict, new: dict,
                  noise_pp: float = DEFAULT_NOISE_PP,
                  active_only: bool = False) -> List[dict]:
    """Frames whose SELF-SHARE moved more than ``noise_pp`` percentage
    points between two profiles, biggest regression first. Shares (not
    raw hits) so profiles of different lengths diff honestly; a frame
    absent from one side diffs against share 0."""
    old_total = max(old["total"], 1)
    new_total = max(new["total"], 1)
    names = set(old["frames"]) | set(new["frames"])
    out = []
    for name in names:
        if active_only and _frame_idle(name):
            continue
        a = old["frames"].get(name, (0, 0))[0] / old_total
        b = new["frames"].get(name, (0, 0))[0] / new_total
        delta_pp = (b - a) * 100.0
        if abs(delta_pp) <= noise_pp:
            continue
        out.append({
            "frame": name,
            "old_share": round(a, 4),
            "new_share": round(b, 4),
            "delta_pp": round(delta_pp, 2),
        })
    out.sort(key=lambda r: (-r["delta_pp"], r["frame"]))
    return out


# -- rendering ----------------------------------------------------------------


def render_table(profile: dict, top: int = DEFAULT_TOP,
                 active_only: bool = False) -> str:
    rows = hot_rows(profile, top=top, active_only=active_only)
    lines = [
        f"profile {profile['source']}: {profile['total']} stack sample(s), "
        f"{len(profile['frames'])} frame(s)"
        + (" [active only]" if active_only else ""),
        f"  {'self%':>6} {'cum%':>6} {'hits':>8}  frame",
    ]
    for r in rows:
        mark = " ~" if r["idle"] else ""
        lines.append(
            f"  {100 * r['self_share']:>5.1f}% {100 * r['cum_share']:>5.1f}% "
            f"{r['self']:>8}  {r['frame']}{mark}"
        )
    if not rows:
        lines.append("  (no samples)")
    return "\n".join(lines)


def render_diff(movers: List[dict], old: dict, new: dict,
                top: int = DEFAULT_TOP, noise_pp: float = DEFAULT_NOISE_PP
                ) -> str:
    lines = [
        f"diff {old['source']} -> {new['source']} "
        f"({old['total']} -> {new['total']} samples, "
        f"noise floor {noise_pp:.2f}pp):",
    ]
    if not movers:
        lines.append(
            "  no frame's self-share moved past the noise floor"
        )
        return "\n".join(lines)
    lines.append(f"  {'old%':>6} {'new%':>6} {'delta':>8}  frame")
    for r in movers[:top]:
        lines.append(
            f"  {100 * r['old_share']:>5.1f}% {100 * r['new_share']:>5.1f}% "
            f"{r['delta_pp']:>+7.2f}pp  {r['frame']}"
        )
    if len(movers) > top:
        lines.append(f"  ... {len(movers) - top} more mover(s)")
    return "\n".join(lines)


# -- selfcheck ----------------------------------------------------------------

#: the child's workload: a named busy loop the parent must find by name
_SELFCHECK_CODE = """
import sys, time
from gol_distributed_final_tpu_torch.obs import profiler

def selfcheck_spin(deadline):
    x = 0
    while time.perf_counter() < deadline:
        x = (x * 1103515245 + 12345) % (2 ** 31)
    return x

p = profiler.enable(period_ms=2.0, out_dir=sys.argv[1], tag="selfcheck")
selfcheck_spin(time.perf_counter() + float(sys.argv[2]))
p.stop()
paths = p.write_artifacts(sys.argv[1], "selfcheck")
profiler.disable()
print(paths[0])
"""


def selfcheck(spin_s: float = 0.8, verbose: bool = True) -> int:
    """Sample a busy-loop subprocess end to end; assert the hot
    function is named in its artifact. Returns 0 on success."""
    with tempfile.TemporaryDirectory(prefix="gol-flame-") as td:
        proc = subprocess.run(
            [sys.executable, "-c", _SELFCHECK_CODE, td, str(spin_s)],
            capture_output=True, text=True, timeout=120,
            cwd=str(pathlib.Path(__file__).resolve().parent.parent.parent),
        )
        if proc.returncode != 0:
            print(
                f"flame selfcheck FAIL: child exited {proc.returncode}\n"
                f"{proc.stderr}", file=sys.stderr,
            )
            return 1
        artifact = proc.stdout.strip().splitlines()[-1]
        prof = load_collapsed(artifact)
        rows = hot_rows(prof, top=3, active_only=True)
        hot = rows[0]["frame"] if rows else "<none>"
        if "selfcheck_spin" not in hot:
            print(
                f"flame selfcheck FAIL: expected selfcheck_spin as the "
                f"hot frame, got {hot!r} "
                f"({prof['total']} samples)", file=sys.stderr,
            )
            return 1
        if verbose:
            print(
                f"flame selfcheck ok: {hot} holds "
                f"{100 * rows[0]['self_share']:.0f}% of "
                f"{prof['total']} samples"
            )
        return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="render/merge/diff continuous profiles "
                    "(obs/profiler.py artifacts, live -profile "
                    "endpoints, BENCH rounds)"
    )
    parser.add_argument(
        "sources", nargs="*", metavar="SOURCE",
        help="profile sources, merged: an artifact path (.collapsed / "
             ".speedscope.json / BENCH_r*.json) or a live endpoint "
             "(broker:HOST:PORT, worker:HOST:PORT)",
    )
    parser.add_argument(
        "-diff", nargs=2, metavar=("OLD", "NEW"), default=None,
        help="diff two sources instead: frames whose self-share moved "
             "past the noise floor, regressions first",
    )
    parser.add_argument(
        "-top", type=int, default=DEFAULT_TOP, metavar="N",
        help=f"rows rendered (default {DEFAULT_TOP})",
    )
    parser.add_argument(
        "-active", action="store_true",
        help="exclude parked frames (accept/select/wait leaves) — the "
             "busy view",
    )
    parser.add_argument(
        "-noise", type=float, default=DEFAULT_NOISE_PP, metavar="PP",
        help="diff noise floor in percentage points of self-share "
             f"(default {DEFAULT_NOISE_PP})",
    )
    parser.add_argument(
        "-out", default=None, metavar="PATH",
        help="also write the merged profile as a collapsed artifact",
    )
    parser.add_argument(
        "-timeout", type=float, default=5.0, metavar="SECS",
        help="bound per live Status fetch (default 5)",
    )
    parser.add_argument(
        "--selfcheck", action="store_true",
        help="loopback check: profile a busy-loop subprocess, assert "
             "the hot function is named",
    )
    args = parser.parse_args(argv)
    if args.selfcheck:
        return selfcheck()
    if args.diff:
        try:
            old = load_source(args.diff[0], timeout=args.timeout)
            new = load_source(args.diff[1], timeout=args.timeout)
        except Exception as exc:
            print(f"flame: cannot load profile: {exc}", file=sys.stderr)
            return 1
        movers = diff_profiles(
            old, new, noise_pp=args.noise, active_only=args.active
        )
        print(render_diff(movers, old, new, top=args.top,
                          noise_pp=args.noise))
        return 0
    if not args.sources:
        parser.error("need at least one SOURCE (or -diff / --selfcheck)")
    profiles = []
    for s in args.sources:
        try:
            profiles.append(load_source(s, timeout=args.timeout))
        except Exception as exc:
            print(f"flame: cannot load {s}: {exc}", file=sys.stderr)
            return 1
    prof = profiles[0] if len(profiles) == 1 else merge_profiles(profiles)
    print(render_table(prof, top=args.top, active_only=args.active))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        lines = [
            f"merged;{name} {s}"
            for name, (s, _c) in sorted(prof["frames"].items()) if s
        ]
        tmp = out.with_name(out.name + ".tmp")
        tmp.write_text("\n".join(lines) + "\n")
        tmp.replace(out)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
