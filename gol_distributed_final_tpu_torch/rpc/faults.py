"""Deterministic fault injection — the harness the recovery paths are proven by.

A copy of the JAX package's ``rpc/faults.py`` (the port imports nothing of
that package). Two complementary mechanisms, both dependency-free and off
unless a test (or an operator running a game-day) opts in:

* ``ChaosProxy`` — a frame-aware TCP proxy that sits between an RpcClient
  and an RpcServer and injects transport faults on the length-prefixed
  frame stream (rpc/protocol.py framing): per-frame ``delay``,
  ``wedge_after=N`` (stop forwarding after the N-th frame but hold the
  sockets open — the stalled-but-alive worker the per-scatter deadline
  exists for), ``drop_after=N`` (hard connection close — the SIGKILLed
  peer), ``corrupt_frame=N`` (flip payload bytes of exactly frame N,
  inside the pickle so it is always loud; byte positions come from the
  constructor ``seed``, so a failing run replays), and
  ``corrupt_sidecar=N`` (flip ONE BIT inside a raw ndarray sidecar of the
  first flagged frame >= N — the silent corruption class the checked-frame
  layer in rpc/integrity.py exists to catch). The global frame counter
  spans all connections and both directions, so a wedge also starves NEW
  connections — the broker's readmission probe cannot readmit a worker
  through a wedged path.

* ``fault_point(name)`` — in-process fault sites compiled into the worker
  dispatch, the RPC server, and the broker turn loop, triggered by the
  ``GOL_FAULT_POINTS`` env var (parsed once per process) or
  ``configure()`` in tests. Spec: comma-separated ``name:action:k[:arg]``
  entries — ``raise`` (FaultInjected on exactly the k-th hit), ``exit``
  (``os._exit(70)`` on the k-th hit: the crash that runs no finallys),
  ``sleep`` (sleep ``arg`` seconds on every hit >= k), ``wedge`` (block
  forever from hit k on), ``corrupt`` (flip one byte of the site's exposed
  ndarray in place on the k-th hit — ``worker.strip_corrupt`` exposes the
  resident strip). With the env var unset a fault point costs one global
  read and a dict check.
"""

from __future__ import annotations

import os
import random
import socket
import threading
import time
from typing import Optional

# the proxy frames with the REAL wire header: a private-but-shared import
# beats re-declaring the struct (a protocol framing change must re-frame
# the chaos proxy too, not silently desync it)
from .integrity import CK_WORD_SIZE
from .protocol import (
    _FLAG_CK,
    _FLAG_OOB,
    _HEADER,
    _LEN_MASK,
    _OOB_LEN,
    _OOB_SUB,
    _recv_exact,
)


class FaultInjected(RuntimeError):
    """Raised by a ``raise``-action fault point — distinguishable from any
    organic failure, so a chaos test knows its fault (and nothing else)
    fired."""


# -- in-process fault points -------------------------------------------------

_ENV = "GOL_FAULT_POINTS"
_lock = threading.Lock()
_spec: Optional[dict] = None
_loaded = False
_hits: dict = {}


def _parse(text: str) -> dict:
    """``name:action:k[:arg]`` entries, comma-separated. Malformed entries
    raise ValueError loudly: a chaos run with a typoed spec must not
    silently run fault-free and "pass"."""
    spec: dict = {}
    for entry in filter(None, (e.strip() for e in text.split(","))):
        parts = entry.split(":")
        if len(parts) not in (2, 3, 4):
            raise ValueError(f"bad fault spec entry {entry!r}")
        name, action = parts[0], parts[1]
        if action not in ("raise", "exit", "sleep", "wedge", "corrupt"):
            raise ValueError(f"unknown fault action {action!r} in {entry!r}")
        k = int(parts[2]) if len(parts) > 2 else 1
        arg = float(parts[3]) if len(parts) > 3 else 0.0
        if action == "sleep" and len(parts) < 4:
            raise ValueError(f"sleep needs seconds: {entry!r} wants :k:secs")
        spec[name] = (action, k, arg)
    return spec


def configure(text: Optional[str]) -> None:
    """Test hook: install a spec string directly (None: forget it and
    re-read the env var on the next hit). Resets the hit counters."""
    global _spec, _loaded
    with _lock:
        _spec = _parse(text) if text else None
        _loaded = text is not None
        _hits.clear()


def fault_point(name: str, target=None) -> None:
    """A named site a fault can be injected at. No-op (one global read)
    unless ``GOL_FAULT_POINTS`` / ``configure`` named this site.

    ``target`` is an optional mutable ndarray the site exposes to the
    ``corrupt`` action (``name:corrupt:k[:flat_index]``): on exactly the
    k-th hit one byte of it is flipped IN PLACE — the silent-state
    corruption the integrity digest chain (rpc/integrity.py) exists to
    catch. Sites that pass no target make ``corrupt`` a no-op there."""
    global _spec, _loaded
    if not _loaded:
        with _lock:
            if not _loaded:
                env = os.environ.get(_ENV, "")
                _spec = _parse(env) if env else None
                _loaded = True
    spec = _spec
    if not spec:
        return
    entry = spec.get(name)
    if entry is None:
        return
    with _lock:
        _hits[name] = n = _hits.get(name, 0) + 1
    action, k, arg = entry
    if action == "sleep":
        if n >= k:
            time.sleep(arg)
    elif action == "wedge":
        if n >= k:
            threading.Event().wait()  # forever: the alive-but-silent hang
    elif n == k:
        if action == "raise":
            raise FaultInjected(f"fault point {name!r} fired on hit {n}")
        if action == "exit":
            # no finallys, no flushes — the deterministic kill -9
            os._exit(70)
        if action == "corrupt" and target is not None and target.size:
            # deterministic single-byte flip at flat index ``arg`` (mod
            # size). XOR 0xFF maps a 0/255 cell to its VALID opposite —
            # exactly the plausible-looking wrong bit nothing downstream
            # would notice without a digest
            flat = target.reshape(-1)
            flat[int(arg) % flat.size] ^= 0xFF


# -- TCP chaos proxy ---------------------------------------------------------


class ChaosProxy:
    """Frame-aware TCP proxy injecting deterministic transport faults.

    ``target`` is the real server's ``host:port``; clients dial
    ``proxy.address`` instead. Faults can be set at construction or
    swapped live with ``set_fault`` (a game-day lever). ``close()`` tears
    down the listener and every proxied connection, releasing wedged
    pump threads."""

    def __init__(
        self,
        target: str,
        *,
        seed: int = 0,
        listen_host: str = "127.0.0.1",
        listen_port: int = 0,
        delay: float = 0.0,
        wedge_after: Optional[int] = None,
        drop_after: Optional[int] = None,
        corrupt_frame: Optional[int] = None,
        corrupt_sidecar: Optional[int] = None,
    ):
        host, port = target.rsplit(":", 1)
        self._target = (host, int(port))
        self._seed = seed
        self._lock = threading.Lock()
        self._frames = 0
        self._sidecar_corrupted = False
        self._faults = {
            "delay": delay,
            "wedge_after": wedge_after,
            "drop_after": drop_after,
            "corrupt_frame": corrupt_frame,
            "corrupt_sidecar": corrupt_sidecar,
        }
        self._closed = threading.Event()
        self._conns: list = []
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, listen_port))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    @property
    def frames_forwarded(self) -> int:
        with self._lock:
            return self._frames

    def set_fault(self, **kw) -> None:
        """Update fault knobs live (``delay`` / ``wedge_after`` /
        ``drop_after`` / ``corrupt_frame``)."""
        bad = set(kw) - set(self._faults)
        if bad:
            raise ValueError(f"unknown fault knob(s): {sorted(bad)}")
        with self._lock:
            self._faults.update(kw)

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                break
            if self._closed.is_set():
                # a thread parked in accept() holds the closed listener
                # alive in the kernel: a dial racing close() can still be
                # accepted here and must be refused, not proxied
                conn.close()
                break
            try:
                upstream = socket.create_connection(self._target, timeout=5)
            except OSError:
                conn.close()
                continue
            upstream.settimeout(None)  # connect timeout must not bound reads
            for s in (conn, upstream):
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns += [conn, upstream]
            threading.Thread(
                target=self._pump, args=(conn, upstream), daemon=True
            ).start()
            threading.Thread(
                target=self._pump, args=(upstream, conn), daemon=True
            ).start()

    def _pump(self, src: socket.socket, dst: socket.socket) -> None:
        try:
            while True:
                head = _recv_exact(src, _HEADER.size)
                (word,) = _HEADER.unpack(head)
                # mask the protocol-5 out-of-band flag bit: a flagged
                # header's length field is the body length either way, and
                # the body (subheader + pickle + sidecar buffers) forwards
                # as one opaque blob. A CHECKED frame carries a crc32
                # word behind the length word (rpc/protocol.py) — part of
                # the header, forwarded untouched: corruption lands in
                # the BODY, and the stale crc is exactly what convicts it
                oob = bool(word & _FLAG_OOB)
                if word & _FLAG_CK:
                    head += _recv_exact(src, CK_WORD_SIZE)
                length = word & _LEN_MASK
                payload = _recv_exact(src, length)
                with self._lock:
                    idx = self._frames
                    self._frames += 1
                    faults = dict(self._faults)
                if faults["delay"]:
                    time.sleep(faults["delay"])
                wedge = faults["wedge_after"]
                if wedge is not None and idx >= wedge:
                    # hold both sockets open, forward nothing: the peer
                    # sees a connection that is up but silent
                    self._closed.wait()
                    return
                drop = faults["drop_after"]
                if drop is not None and idx >= drop:
                    return  # finally closes both: the hard kill
                sidecar = faults["corrupt_sidecar"]
                if (
                    sidecar is not None
                    and idx >= sidecar
                    and oob
                    and not self._sidecar_corrupted
                ):
                    # flip ONE BIT inside a raw ndarray sidecar buffer —
                    # the silent-board-corruption fault corrupt_frame
                    # deliberately never lands (its flips stay inside the
                    # pickle so they surface as unpickling errors). This
                    # knob exists to prove the checked-frame layer
                    # (rpc/integrity.py): against a checksum-negotiated
                    # peer the flip is a loud IntegrityError; against an
                    # -integrity off peer it IS a silently-wrong board —
                    # by design, that run is undefended. Fires once, on
                    # the first flagged frame >= N that carries sidecar
                    # bytes.
                    body = bytearray(payload)
                    if length > _OOB_SUB.size:
                        nbufs, pickle_len = _OOB_SUB.unpack_from(body, 0)
                        s0 = _OOB_SUB.size + _OOB_LEN.size * nbufs + pickle_len
                        s_end = length
                        if s_end > s0:
                            rng = random.Random(self._seed ^ idx)
                            pos = rng.randrange(s0, s_end)
                            body[pos] ^= 1 << rng.randrange(8)
                            payload = bytes(body)
                            self._sidecar_corrupted = True
                corrupt = faults["corrupt_frame"]
                if corrupt is not None and idx == corrupt and length:
                    body = bytearray(payload)
                    # corrupt_frame's corruption must land INSIDE the
                    # pickle bytes so it surfaces loudly even against an
                    # un-negotiated peer (UnpicklingError on a plain
                    # frame; IntegrityError first on a checked one): for
                    # a plain frame the pickle IS the body (byte 0 = the
                    # PROTO opcode); for an out-of-band frame the pickle
                    # sits after the subheader. Flipping a sidecar BUFFER
                    # byte is the SILENT corruption class — that is the
                    # separate, deliberate corrupt_sidecar knob above
                    if oob and length > _OOB_SUB.size:
                        nbufs, pickle_len = _OOB_SUB.unpack_from(body, 0)
                        p0 = _OOB_SUB.size + _OOB_LEN.size * nbufs
                        p_end = min(p0 + pickle_len, length)
                    else:
                        p0, p_end = 0, length
                    if p_end > p0:
                        body[p0] ^= 0xFF  # the PROTO opcode
                        if p_end - p0 > 1:
                            rng = random.Random(self._seed ^ idx)
                            for _ in range(3):
                                body[rng.randrange(p0 + 1, p_end)] ^= 0xFF
                    payload = bytes(body)
                dst.sendall(head + payload)
        except (OSError, ConnectionError):
            pass
        finally:
            for s in (src, dst):
                try:
                    s.close()
                except OSError:
                    pass

    def close(self) -> None:
        self._closed.set()
        try:
            # wake a blocked accept() (close alone leaves it holding the
            # kernel socket alive — it would accept one more connection)
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for s in conns:
            try:
                s.close()
            except OSError:
                pass
