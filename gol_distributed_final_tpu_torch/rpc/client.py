"""RPC client with concurrent in-flight calls (the rpc.Client role).

A copy of the JAX package's ``rpc/client.py``: each call is metered
(requests, errors, bytes, seconds), traced as a span whose context rides
``Request.trace_ctx``, and stamped with the hybrid logical clock
(obs/journal.py) both ways. The controller needs the concurrency: its
main thread blocks in ``Operations.Run`` for the whole game while the
ticker thread issues ``RetrieveCurrentData``/``Pause`` on the same
connection (gol/distributor.go:159 + :45). Calls are multiplexed by id; a
reader thread routes replies to per-call events.
"""

from __future__ import annotations

import itertools
import random
import socket
import threading
import time

from ..obs import flight as _flight
from ..obs import instruments as _ins
from ..obs import journal as _journal
from ..obs import metrics as _metrics
from ..obs import tracing as _tracing
from ..utils import locksan as _locksan
from . import integrity as _integrity
from .protocol import Methods, Request, recv_frame_sized, send_frame


class RpcError(Exception):
    """A server-side error surfaced to the caller (net/rpc's error return).

    ``kind`` is the remote exception's class name and ``remote_traceback``
    its truncated traceback; ``reason`` the machine-readable refusal reason
    when the remote exception carried one (``SessionRejected.reason``).
    All three are None against a peer that does not send them.
    ``is_reply`` tells an error the SERVER sent (the peer is alive) from a
    transport failure raised on this side."""

    is_reply = False

    def __init__(self, message, kind=None, remote_traceback=None, reason=None):
        super().__init__(message)
        self.kind = kind
        self.remote_traceback = remote_traceback
        self.reason = reason


_RECONNECT_BACKOFF0 = 0.2  # first retry delay; doubles per failure


class RpcClient:
    """``reconnect=True`` makes the transport self-healing: when the
    connection dies, the NEXT call dials again under capped jittered
    exponential backoff. Calls in flight when the connection died always
    FAIL — no verb is ever silently re-sent (Run/Pause/Quit are not
    idempotent)."""

    def __init__(
        self,
        address: str,
        timeout: float | None = None,
        reconnect: bool = False,
        max_backoff: float = 15.0,
    ):
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._connect_timeout = timeout
        self._reconnect = reconnect
        self._max_backoff = max_backoff
        self._backoff = 0.0
        self._retry_at = 0.0  # monotonic gate for the next dial attempt
        # guards transport swaps and the backoff state; never held across
        # a dial, so close() and other threads' calls stay prompt
        self._conn_lock = _locksan.lock("RpcClient._conn_lock")
        self._dialing = False
        self._user_closed = False
        self._ids = itertools.count()
        self._pending: dict[int, dict] = {}
        self._pending_lock = _locksan.lock("RpcClient._pending_lock")
        # ONE write lock for the client's lifetime: a sender that took it
        # just before a reconnect swapped the socket must still exclude
        # senders on the new one, or their frames would interleave
        self._write_lock = _locksan.lock("RpcClient._write_lock")
        self._install(self._dial())

    def _dial(self) -> socket.socket:
        sock = socket.create_connection(self._addr, timeout=self._connect_timeout)
        sock.settimeout(None)
        # send_frame writes header and payload separately; without NODELAY
        # Nagle holds the second write for the peer's delayed ACK
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _install(self, sock: socket.socket) -> None:
        """Publish a fresh transport — ONE tuple (socket, closed Event), so
        a concurrent call captures both atomically — and start its reader.
        Negotiation resets per transport: a reconnect may land on an older
        peer."""
        self._peer_oob = False
        self._peer_ck = False
        closed = threading.Event()
        self._transport = (sock, closed)
        threading.Thread(target=self._read_loop, args=(sock, closed), daemon=True).start()

    def _read_loop(self, sock: socket.socket, closed: threading.Event) -> None:
        # broad catch: a rejected or corrupt reply frame must fail every
        # pending call, not silently kill this thread and hang them
        try:
            while True:
                msg, nbytes = recv_frame_sized(sock)
                with self._pending_lock:
                    slot = self._pending.pop(msg["id"], None)
                if slot is not None:
                    slot["reply"] = msg
                    slot["reply_bytes"] = nbytes
                    slot["event"].set()
        except Exception:  # noqa: BLE001
            closed.set()
            with self._pending_lock:
                # only the CURRENT transport's reader may drain: a stale
                # reader after a reconnect must not fail new calls
                if closed is self._transport[1]:
                    for slot in self._pending.values():
                        slot["event"].set()
                    self._pending.clear()

    @staticmethod
    def _drop(sock: socket.socket) -> None:
        # shutdown first: close() alone does not wake a thread blocked in
        # sendall or recv on the socket
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _maybe_reconnect(self) -> None:
        """Called when a call finds the transport dead: installs a fresh
        connection or raises RpcError. One dial at a time, outside the
        lock, paced by the backoff."""
        if not self._reconnect or self._user_closed:
            raise RpcError("connection closed")
        with self._conn_lock:
            if self._user_closed:
                raise RpcError("connection closed")
            old_sock, old_closed = self._transport
            if not old_closed.is_set():
                return  # another thread already reconnected
            if self._dialing:
                raise RpcError(
                    f"connection to {self._addr[0]}:{self._addr[1]} is down; "
                    "a reconnect attempt is already in progress"
                )
            now = time.monotonic()
            if now < self._retry_at:
                raise RpcError(
                    f"connection to {self._addr[0]}:{self._addr[1]} is down; "
                    f"reconnect backing off {self._retry_at - now:.1f}s"
                )
            self._dialing = True
            _ins.RPC_RETRIES_TOTAL.inc()
            _flight.record("rpc.reconnect", f"{self._addr[0]}:{self._addr[1]}")
            self._drop(old_sock)
            with self._pending_lock:
                # anything still pending rode the dead connection: fail it
                for slot in self._pending.values():
                    slot["event"].set()
                self._pending.clear()
        try:
            sock = self._dial()
        except OSError as e:
            with self._conn_lock:
                self._dialing = False
                self._backoff = min(
                    self._max_backoff, (self._backoff * 2) or _RECONNECT_BACKOFF0
                )
                self._retry_at = time.monotonic() + self._backoff * random.uniform(0.5, 1.5)
            raise RpcError(
                f"reconnect to {self._addr[0]}:{self._addr[1]} failed: {e}"
            ) from e
        with self._conn_lock:
            self._dialing = False
            if self._user_closed:
                self._drop(sock)  # close() won while we dialed
                raise RpcError("connection closed")
            self._install(sock)
            self._backoff = 0.0
            self._retry_at = 0.0

    def call(
        self,
        method: str,
        request: Request,
        timeout: float | None = None,
        trace_parent: dict | None = None,
    ):
        """Blocking call, safe from any thread. ``timeout`` bounds the wait
        for the REPLY (None: forever — Run blocks for the whole game); on
        expiry the pending slot is dropped and RpcError raised, so a wedged
        server cannot hang a poller (obs/status.py).

        ``trace_parent`` explicitly parents this call's span for work
        handed to pool threads (where the caller's thread-local span stack
        is invisible — the workers-backend scatter); by default the span
        parents on the calling thread's current span."""
        if not _metrics.enabled() and not _tracing.enabled():
            return self._call(method, request, timeout)
        span = _tracing.start_span(
            _tracing.SPAN_RPC_CLIENT, parent_ctx=trace_parent, method=method
        )
        if span is not None and isinstance(request, Request):
            request.trace_ctx = span.ctx()
        _flight.record("rpc.send", method)
        if _metrics.enabled():
            _ins.RPC_CLIENT_REQUESTS_TOTAL.labels(method).inc()
        t0 = time.monotonic()
        err_kind = None
        try:
            result = self._call(method, request, timeout)
            _flight.record("rpc.recv", method, ok=True)
            if span is not None:
                peer = getattr(result, "trace_ctx", None)
                if isinstance(peer, dict):
                    span.args["server_span_id"] = peer.get("span_id")
            return result
        except RpcError as e:
            err_kind = e.kind or type(e).__name__
            _flight.record("rpc.recv", method, ok=False, error_kind=err_kind)
            if _metrics.enabled():
                _ins.RPC_CLIENT_ERRORS_TOTAL.labels(method).inc()
            raise
        finally:
            if _metrics.enabled():
                _ins.RPC_CLIENT_REQUEST_SECONDS.labels(method).observe(
                    time.monotonic() - t0
                )
            if err_kind is None:
                _tracing.end_span(span)
            else:
                _tracing.end_span(span, error_kind=err_kind)

    def _call(self, method: str, request: Request, timeout: float | None = None):
        # every outbound request carries this process's hybrid-logical-
        # clock stamp (obs/journal.py), so the server's events order after
        # the ones that caused the call
        if isinstance(request, Request):
            request.hlc = _journal.stamp()
        sock, closed = self._transport
        if closed.is_set():
            self._maybe_reconnect()  # raises unless a fresh transport is up
            sock, closed = self._transport
        call_id = next(self._ids)
        slot = {"event": threading.Event(), "reply": None}
        with self._pending_lock:
            self._pending[call_id] = slot
        # re-check after registering: if the reader died in between, it has
        # already drained _pending and this slot would never be set
        if closed.is_set():
            with self._pending_lock:
                self._pending.pop(call_id, None)
            raise RpcError("connection closed")
        try:
            with self._write_lock:
                # "oob": 1 advertises that this side parses protocol-5
                # frames, "ck": 1 that it verifies checked ones; the frame
                # itself upgrades only once the PEER advertised in a reply
                envelope = {"id": call_id, "method": method, "request": request, "oob": 1}
                if _integrity.enabled():
                    envelope["ck"] = 1
                # gol: allow(blocking-under-lock): deliberate — ONE
                # writer at a time per stream is the framing contract
                # (header+payload must not interleave), so the send
                # happens under the lifetime write lock by design; a
                # sender stuck in sendall is woken by close()/reconnect
                # via socket.shutdown (see _maybe_reconnect and close)
                sent = send_frame(
                    sock, envelope, oob=self._peer_oob,
                    checksum=self._peer_ck and _integrity.enabled(),
                )
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(call_id, None)
            # this transport is gone: the next call reconnects, and the
            # shutdown wakes the reader so concurrent callers unblock
            closed.set()
            self._drop(sock)
            raise RpcError(f"send failed: {e}") from e
        if _metrics.enabled():
            _ins.RPC_CLIENT_SENT_BYTES_TOTAL.labels(method).inc(sent)
            _ins.WIRE_BYTES_TOTAL.labels(method, "sent").inc(sent)
        if not slot["event"].wait(timeout):
            with self._pending_lock:
                self._pending.pop(call_id, None)
            raise RpcError(f"no reply to {method} within {timeout}s")
        reply = slot["reply"]
        if reply is None:
            raise RpcError("connection closed before reply")
        if _metrics.enabled():
            _ins.RPC_CLIENT_RECEIVED_BYTES_TOTAL.labels(method).inc(slot.get("reply_bytes", 0))
            _ins.WIRE_BYTES_TOTAL.labels(method, "received").inc(slot.get("reply_bytes", 0))
        if reply.get("oob"):
            self._peer_oob = True
        if reply.get("ck"):
            self._peer_ck = True
        if "error" in reply:
            err = RpcError(
                reply["error"],
                kind=reply.get("error_kind"),
                remote_traceback=reply.get("error_traceback"),
                reason=reply.get("error_reason"),
            )
            err.is_reply = True
            raise err
        # gol: allow(skew-safety): 'result' is a REQUIRED key of every
        # non-error reply in every protocol version — a missing key is a
        # malformed envelope that must fail loudly, not default to None
        # (None is a legitimate result value)
        result = reply["result"]
        _journal.observe(getattr(result, "hlc", None))
        return result

    def close(self) -> None:
        # _user_closed first: a reconnect mid-dial re-checks it under the
        # lock before installing, so nothing leaks
        self._user_closed = True
        with self._conn_lock:
            sock, closed = self._transport
        closed.set()
        self._drop(sock)


class RemoteBroker:
    """The controller-side broker handle: the same surface as
    ``InProcessBroker``, served over RPC (the rpc.Dial("tcp", *server)
    role, gol/distributor.go:136)."""

    def __init__(
        self,
        address: str = "127.0.0.1:8040",
        timeout: float | None = 10.0,
        reconnect: bool = True,
    ):
        # reconnect by default: the ticker keeps polling Retrieve across a
        # broker restart; the blocking Run in flight still FAILS
        self.client = RpcClient(address, timeout=timeout, reconnect=reconnect)

    def run(
        self,
        params,
        world,
        *,
        emit=None,
        emit_flips=False,
        initial_turn=0,
        rule=None,
        halo_depth=0,
    ):
        # emit/emit_flips are single-host features; the distributed
        # reference never emits CellFlipped/TurnComplete either
        req = Request(
            world=world,
            turns=params.turns,
            image_height=params.image_height,
            image_width=params.image_width,
            threads=params.threads,
            initial_turn=initial_turn,
            rulestring=rule.rulestring if rule is not None else "",
            halo_depth=halo_depth,
        )
        res = self.client.call(Methods.BROKER_RUN, req)
        from ..engine.engine import RunResult

        # brokers ship alive=[] (cells derive from the world); a non-empty
        # list from a server that does ship cells is honoured
        return RunResult(res.turns_completed, res.world, alive=res.alive or None)

    def session_run(
        self,
        params,
        world,
        *,
        session_id: int = 0,
        rule=None,
        timeout: float | None = None,
    ):
        """Blocking multi-universe Run (Operations.SessionRun): this
        universe joins the broker's device-batched session table and the
        call returns ITS final board. Many may be issued concurrently
        (each on its own connection and thread); a nonzero ``session_id``
        tags the session so ``retrieve(session_id=...)`` serves it
        mid-flight. Admission refusals surface as RpcError replies with
        ``kind == "SessionRejected"`` and ``reason`` set."""
        req = Request(
            world=world,
            turns=params.turns,
            image_height=params.image_height,
            image_width=params.image_width,
            threads=params.threads,
            rulestring=rule.rulestring if rule is not None else "",
            session_id=session_id,
        )
        res = self.client.call(Methods.SESSION_RUN, req, timeout=timeout)
        from ..engine.engine import RunResult

        return RunResult(res.turns_completed, res.world, alive=res.alive or None)

    def pause(self):
        self.client.call(Methods.PAUSE, Request())

    def quit(self):
        self.client.call(Methods.QUIT, Request())

    def super_quit(self):
        self.client.call(Methods.SUPER_QUIT, Request())

    def retrieve(self, include_world: bool = True, session_id: int = 0):
        # a nonzero session_id serves ONE universe of the session batch
        res = self.client.call(
            Methods.RETRIEVE,
            Request(include_world=include_world, session_id=session_id),
        )
        from ..engine.engine import Snapshot

        return Snapshot(res.world, res.turns_completed, res.alive_count)

    def status(self, timeout: float = 10.0) -> dict:
        """Read-only metrics snapshot of the remote broker (the Status
        verb, obs/). Empty dict from a server whose Response carries none.
        ``timeout`` bounds the reply wait: the controller's end-of-session
        trace export calls this, and a broker wedged after the run must
        cost seconds, not hang the session's exit."""
        res = self.client.call(Methods.STATUS, Request(), timeout=timeout)
        return getattr(res, "status", None) or {}

    def close(self):
        self.client.close()
