"""Per-tenant usage accounting — who is spending this cluster's capacity.

The serving stack meters the CLUSTER (PR 7 session counters, PR 8 SLO
timelines) but attributes nothing to a TENANT: a noisy client's capacity
rejects, device-seconds, and error-budget burn are indistinguishable from
everyone else's. The multi-tenant front door on the ROADMAP is gated on
exactly that attribution — per-tenant SLO-driven admission needs a ledger
to admit against before it can be built.

**Tenant identity** rides the existing client-chosen ``Request.session_id``
tag (no new wire field): the tag's HIGH 32 bits are the tenant id, the low
32 bits the per-session nonce (``tenant_of``). A plain small tag (high
bits zero — every pre-convention client) is its own tenant, so old
clients attribute per-tag instead of failing. ``0`` / untagged sessions
land on the ``"-"`` tenant.

**Bounded cardinality** is the contract that makes the ledger safe against
a hostile tag flood: at most ``top_k`` tenants are tracked individually;
every tenant past that folds into ONE ``other`` bucket — memory is
O(top_k) regardless of how many distinct tags arrive. (First-K keyed,
not a true heavy-hitter sketch: the tenants that matter arrive early in
practice, and ``other``'s aggregate keeps the totals exact either way.)

**What is attributed, and where:**

* device-seconds + universe-turns — at ``SessionTable.advance`` chunk
  boundaries (engine/sessions.py): each chunk's dispatch wall splits
  evenly over the universes it advanced, so the per-tenant device-second
  sum reconciles exactly with ``gol_session_turn_seconds``'s sum and the
  per-tenant turn sum with ``gol_session_turns_total``.
* admission waits + board bytes in — at ``SessionScheduler.submit``.
* rejects by reason + session errors — the tenant's **SLO-burn
  contribution**: every reject and failed session is an error reply
  against the ``rpc-error-ratio`` budget, so the ledger names who is
  burning it.
* board bytes out — at session completion.

Shipped **incrementally** in ``Status`` like the PR 8 timeline: entries
carry the ledger ``seq`` of their last mutation, and a poller that echoes
``Request.accounting_since`` receives only tenants that changed since
(totals always ride along). Rendered as the watch ``TENANTS`` panel,
folded into RunReport, and fed to ``obs/doctor.py``'s tenant-skew
heuristic.

Like every obs surface: pure stdlib, and **free when metrics are off** —
every record method is one enabled-check and a branch until an entry
point opts in (``-metrics`` / ``-timeline``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from . import metrics as _metrics
from ..utils import locksan as _locksan

SCHEMA = "gol-accounting/1"

#: the session-tag split: high bits = tenant id, low bits = session nonce
TENANT_SHIFT = 32
#: tenants tracked individually before folding into ``other``
DEFAULT_TOP_K = 16


def tenant_of(tag) -> str:
    """The ledger key for one ``Request.session_id`` tag: the tag's high
    32 bits when set (the packing convention loadgen/canary use), else
    the tag itself (a pre-convention small tag is its own tenant);
    ``"-"`` for untagged/invalid — attribution degrades, never raises."""
    if not isinstance(tag, int) or tag <= 0:
        return "-"
    hi = tag >> TENANT_SHIFT
    return str(hi) if hi else str(tag)


def make_tag(tenant: int, nonce: int) -> int:
    """The inverse convention: pack a tenant id and a per-session nonce
    into one ``session_id`` (nonce forced nonzero so the tag never
    collapses to the untagged 0)."""
    return (int(tenant) << TENANT_SHIFT) | ((int(nonce) & 0xFFFFFFFF) or 1)


class _Usage:
    """One tenant's (or the ``other`` bucket's) running totals."""

    __slots__ = (
        "device_seconds", "turns", "wire_bytes", "sessions",
        "admit_waits", "admit_wait_s", "rejects", "errors", "seq",
    )

    def __init__(self):
        self.device_seconds = 0.0
        self.turns = 0
        self.wire_bytes = 0
        self.sessions = 0
        self.admit_waits = 0
        self.admit_wait_s = 0.0
        self.rejects: Dict[str, int] = {}
        self.errors = 0
        self.seq = 0

    def as_dict(self, tenant: str) -> dict:
        rejects = dict(self.rejects)
        return {
            "tenant": tenant,
            "device_seconds": round(self.device_seconds, 6),
            "turns": self.turns,
            "wire_bytes": self.wire_bytes,
            "sessions": self.sessions,
            "admit_waits": self.admit_waits,
            "admit_wait_s_sum": round(self.admit_wait_s, 6),
            "rejects": rejects,
            "rejects_total": sum(rejects.values()),
            "errors": self.errors,
            "seq": self.seq,
        }


class TenantLedger:
    """Bounded per-tenant usage totals (module docstring). All mutators
    are no-ops while the metrics registry is disabled — the ledger's
    on/off switch is the same ``-metrics`` opt-in as every instrument."""

    # every entry and the seq move together under one lock: a Status
    # window must never pair a bumped seq with a half-applied chunk
    # (machine-enforced: analysis/locks.py)
    _GUARDED_BY = {
        "_tenants": "_lock",
        "_other": "_lock",
        "_seq": "_lock",
        "_overflow_seen": "_lock",
    }

    def __init__(self, top_k: int = DEFAULT_TOP_K):
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.top_k = top_k
        self._lock = _locksan.lock("TenantLedger._lock")
        self._tenants: Dict[str, _Usage] = {}
        self._other = _Usage()
        # DISTINCT tenants folded into other — itself bounded (8 x top_k
        # keys, a few KB) so a tag flood can't grow it either: the
        # reported distinct_tenants is exact below the cap and SATURATES
        # at it (a saturated reading IS the flood diagnosis)
        self._overflow_cap = 8 * top_k
        self._overflow_seen: set = set()
        self._seq = 0

    # -- the write surface (each: one enabled-check when metrics are off) --

    def _entry(self, tenant: str) -> _Usage:  # gol: holds(_lock)
        """The tenant's entry, or the ``other`` bucket once ``top_k``
        distinct tenants are tracked (the cardinality bound). Caller
        must hold ``self._lock``."""
        entry = self._tenants.get(tenant)
        if entry is None:
            if len(self._tenants) < self.top_k:
                entry = self._tenants[tenant] = _Usage()
            else:
                if len(self._overflow_seen) < self._overflow_cap:
                    self._overflow_seen.add(tenant)
                entry = self._other
        return entry

    def record_admit(self, tenant: str, wait_s: float, wire_bytes: int) -> None:
        """One admitted session: its admission wait and board bytes in."""
        if not _metrics.enabled():
            return
        with self._lock:
            self._seq += 1
            e = self._entry(tenant)
            e.sessions += 1
            e.admit_waits += 1
            e.admit_wait_s += wait_s
            e.wire_bytes += int(wire_bytes)
            e.seq = self._seq

    def record_chunk(self, tenants, turns: int, wall_s: float) -> None:
        """One batched dispatch: ``turns`` universe-turns for EACH listed
        tenant session, the chunk wall split evenly across them — so the
        ledger's device-second total reconciles with the chunk wall the
        ``gol_session_turn_seconds`` histogram records."""
        if not _metrics.enabled() or not tenants:
            return
        share = wall_s / len(tenants)
        with self._lock:
            self._seq += 1
            for tenant in tenants:
                e = self._entry(tenant)
                e.device_seconds += share
                e.turns += turns
                e.seq = self._seq

    def record_reject(self, tenant: str, reason: str) -> None:
        """One admission refusal — the per-tenant attribution behind the
        anonymous ``gol_sessions_rejected_total{reason}`` pool."""
        if not _metrics.enabled():
            return
        with self._lock:
            self._seq += 1
            e = self._entry(tenant)
            e.rejects[reason] = e.rejects.get(reason, 0) + 1
            e.seq = self._seq

    def record_error(self, tenant: str) -> None:
        """One failed session (error reply to the client) — SLO-burn."""
        if not _metrics.enabled():
            return
        with self._lock:
            self._seq += 1
            e = self._entry(tenant)
            e.errors += 1
            e.seq = self._seq

    def record_reply_bytes(self, tenant: str, nbytes: int) -> None:
        """Board bytes out at session completion."""
        if not _metrics.enabled():
            return
        with self._lock:
            self._seq += 1
            e = self._entry(tenant)
            e.wire_bytes += int(nbytes)
            e.seq = self._seq

    # -- the read surface --------------------------------------------------

    @property
    def has_data(self) -> bool:
        with self._lock:
            return bool(self._tenants) or self._other.seq > 0

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def window(self, since: int = 0) -> dict:
        """The Status payload form: tenants whose last mutation is newer
        than ``since`` (the poller echoes ``Request.accounting_since``,
        exactly like the timeline's ``timeline_since``), sorted by
        device-seconds descending, plus the ``other`` bucket and totals
        (always shipped — they are O(1)). Plain JSON-able: the payload
        crosses the restricted unpickler."""
        with self._lock:
            tenants = [
                e.as_dict(t)
                for t, e in self._tenants.items()
                if e.seq > since
            ]
            other = (
                self._other.as_dict("other")
                if self._other.seq > since else None
            )
            if other is not None:
                other["distinct_tenants"] = len(self._overflow_seen)
            entries = list(self._tenants.values()) + [self._other]
            totals = {
                "device_seconds": round(
                    sum(e.device_seconds for e in entries), 6
                ),
                "turns": sum(e.turns for e in entries),
                "wire_bytes": sum(e.wire_bytes for e in entries),
                "sessions": sum(e.sessions for e in entries),
                "rejects": sum(
                    sum(e.rejects.values()) for e in entries
                ),
                "errors": sum(e.errors for e in entries),
            }
            seq = self._seq
            tracked = len(self._tenants)
        tenants.sort(key=lambda e: -e["device_seconds"])
        return {
            "schema": SCHEMA,
            "seq": seq,
            "top_k": self.top_k,
            "tracked": tracked,
            "tenants": tenants,
            "other": other,
            "totals": totals,
        }

    def totals(self) -> dict:
        """The aggregate row alone (tests, reconciliation checks)."""
        return self.window().get("totals") or {}

    def reset(self) -> None:
        """Zero everything (test/bench isolation, like Registry.reset)."""
        with self._lock:
            self._tenants.clear()
            self._other = _Usage()
            self._overflow_seen.clear()
            self._seq = 0


# -- the process-global default ledger ---------------------------------------

_LEDGER = TenantLedger()


def ledger() -> TenantLedger:
    return _LEDGER
