"""Minimal concurrent RPC server (the net/rpc role, broker/broker.go:284-285).

A copy of the JAX package's ``rpc/server.py`` (the port imports nothing
of that package). One thread per connection and one per in-flight
request, so a blocking ``Operations.Run`` never blocks ``Pause``/
``Retrieve`` arriving on the same or other connections, as Go net/rpc's
goroutine-per-call model. Each dispatch is metered (requests, bytes,
errors, seconds), traced as a span parented on the caller's
``trace_ctx``, and stamped with the process's hybrid logical clock.
"""

from __future__ import annotations

import socket
import threading
import time
import traceback

from ..obs import flight as _flight
from ..obs import instruments as _ins
from ..obs import journal as _journal
from ..obs import metrics as _metrics
from ..obs import tracing as _tracing
from ..utils import locksan as _locksan
from . import faults as _faults
from . import integrity as _integrity
from .protocol import (
    BLOCKING_METHODS,
    Response,
    recv_frame_sized,
    send_frame,
)

# structured error replies carry the remote traceback's TAIL (the raise
# site), truncated so a deep recursion can't balloon an error frame
_TRACEBACK_LIMIT = 2000


def _decode_span(msg, t_body: int) -> None:
    """Commit a request's ``rpc.decode`` span, timed from its body's first
    byte: opened before the request's ``trace_ctx`` could be read, it
    parents on that context (the caller's span) now that it can."""
    envelope = msg if isinstance(msg, dict) else {}
    ctx = getattr(envelope.get("request"), "trace_ctx", None)
    method = envelope.get("method")
    _tracing.add_span(
        _tracing.SPAN_RPC_DECODE, t_body, _tracing.now_ns(),
        parent_ctx=ctx if isinstance(ctx, dict) else None,
        method=method[:64] if isinstance(method, str) else None,
    )


class RpcServer:
    """Binds loopback by default: the transport is pickle-based, so exposure
    beyond the local deployment must be an explicit operator choice
    (``host="0.0.0.0"`` / the -host flag), and even then frames only
    deserialise through the protocol allowlist (protocol.loads_restricted)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._methods: dict[str, callable] = {}
        self._stopped = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._inflight = 0
        self._inflight_cv = _locksan.condition("RpcServer._inflight_cv")

    def register(self, name: str, fn) -> None:
        """Register a handler: fn(request_dataclass) -> response object."""
        self._methods[name] = fn

    def serve_background(self) -> None:
        self._accept_thread = threading.Thread(target=self.serve, daemon=True)
        self._accept_thread.start()

    def serve(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break  # listener closed by stop()
            # see RpcClient: reply frames are two writes; Nagle + delayed
            # ACK would add ~40-200 ms to every small reply
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        write_lock = _locksan.lock("RpcServer.write_lock")
        # per-connection protocol-5 + checksum capability: each flips once
        # the peer's envelope advertises it, after which replies may use
        # out-of-band / checked frames; an old client never advertises and
        # keeps getting plain frames (the skew contract, rpc/protocol.py)
        peer = {"oob": False, "ck": False}
        began: list = []  # where a frame's body began, with the tracer on
        try:
            while True:
                began.clear()
                try:
                    msg, nbytes = recv_frame_sized(conn, began)
                except Exception:
                    # disconnect (ConnectionError/OSError), forbidden global
                    # (pickle.UnpicklingError), truncated pickle (EOFError),
                    # or any other malformed frame: drop the peer — nothing
                    # on this connection can be trusted
                    return
                if began:
                    _decode_span(msg, began[0])
                threading.Thread(
                    target=self._dispatch,
                    args=(conn, write_lock, msg, nbytes, peer),
                    daemon=True,
                ).start()
        finally:
            conn.close()

    def _dispatch(self, conn, write_lock, msg, nbytes: int = 0, peer=None) -> None:
        with self._inflight_cv:
            self._inflight += 1
        t0 = time.monotonic() if _metrics.enabled() else 0.0
        verb = None  # the per-method metric label, once recoverable
        try:
            # anything can be missing or of the wrong type in a frame that
            # deserialised through the allowlist (plain lists/dicts are
            # reachable): every malformed shape gets DEFINED behavior — an
            # error reply whenever the frame named a call id (a client is
            # identifiably waiting, RpcClient.call blocks without timeout),
            # a silent skip only when no id is recoverable
            envelope = msg if isinstance(msg, dict) else {}
            if peer is not None and envelope.get("oob"):
                peer["oob"] = True
            if peer is not None and envelope.get("ck"):
                peer["ck"] = True
            call_id = envelope.get("id")
            if call_id is None:
                return  # not a call envelope: no reply is owed
            method = envelope.get("method")
            request = envelope.get("request")
            fn = self._methods.get(method) if isinstance(method, str) else None
            # bound label cardinality: only REGISTERED verbs label series;
            # arbitrary method strings from a hostile peer collapse to one
            verb = method if fn is not None else "<unknown>"
            if _metrics.enabled():
                _ins.RPC_SERVER_REQUESTS_TOTAL.labels(verb).inc()
                _ins.RPC_SERVER_RECEIVED_BYTES_TOTAL.labels(verb).inc(nbytes)
            # dispatch span, parented on the CLIENT's span via the
            # Request.trace_ctx extension field (getattr: a version-skewed
            # peer's pickle lacks it — skew means "no trace", never an
            # AttributeError). The handler runs on this thread, so engine/
            # backend spans inside it parent here via the thread-local
            # stack, joining the caller's trace across the process boundary.
            # fold the caller's hybrid-logical-clock stamp into this
            # process's clock BEFORE the handler runs (obs/journal.py):
            # every journal event the handler records is then causally
            # ordered after the client-side events that caused the call.
            # Same skew posture as trace_ctx: absent field, no hint.
            _journal.observe(getattr(request, "hlc", None))
            ctx = getattr(request, "trace_ctx", None)
            span = _tracing.start_span(
                _tracing.SPAN_RPC_SERVER,
                parent_ctx=ctx if isinstance(ctx, dict) else None,
                method=verb,
            )
            _flight.record("rpc.dispatch", verb)
            if fn is None:
                reply = {"id": call_id, "error": f"unknown method: {method!r}"}
            else:
                try:
                    # chaos hook (rpc/faults.py): lets GOL_FAULT_POINTS turn
                    # any verb dispatch into a deterministic failure/wedge;
                    # a raise lands as a structured error reply like any
                    # handler exception — defined behavior, not a hang
                    _faults.fault_point("rpc.dispatch")
                    # handler time ONLY (fn itself, success or raise) —
                    # the serving-latency histogram the SLO rulebook
                    # evaluates; REQUEST_SECONDS below keeps covering the
                    # whole dispatch including the reply write. Verbs that
                    # BLOCK by contract (protocol.BLOCKING_METHODS: their
                    # handler wall is the run length) are excluded, or a
                    # healthy long run would page 'rpc-dispatch-latency'.
                    meter_fn = (
                        _metrics.enabled() and verb not in BLOCKING_METHODS
                    )
                    t_fn = time.monotonic() if meter_fn else 0.0
                    try:
                        result = fn(request)
                    finally:
                        if t_fn and _metrics.enabled():
                            _ins.RPC_DISPATCH_SECONDS.labels(verb).observe(
                                time.monotonic() - t_fn
                            )
                    if span is not None and isinstance(result, Response):
                        # reply-side context: lets the client link its
                        # round-trip span to this handler span
                        result.trace_ctx = span.ctx()
                    if isinstance(result, Response):
                        # reply-side clock stamp: the client merges it,
                        # so its later events order after this handler's
                        result.hlc = _journal.stamp()
                    reply = {"id": call_id, "result": result}
                except Exception as e:  # error crosses the wire, like net/rpc
                    # structured: the exception CLASS and raise site cross
                    # too (truncated), so a worker-side failure reaching
                    # the controller is attributable without server logs;
                    # old clients just ignore the extra envelope keys
                    reply = {
                        "id": call_id,
                        "error": f"{type(e).__name__}: {e}",
                        "error_kind": type(e).__name__,
                        "error_traceback": traceback.format_exc()[
                            -_TRACEBACK_LIMIT:
                        ],
                    }
                    # machine-readable refusal reason (SessionRejected's
                    # REJECT_REASONS label): clients classify rejects
                    # without string-matching the message. Skew-safe like
                    # error_kind — an old client ignores the key, an old
                    # server's reply simply lacks it (dict.get)
                    reason = getattr(e, "reason", None)
                    if isinstance(reason, str):
                        reply["error_reason"] = reason
                    _flight.record(
                        "rpc.error", verb, error_kind=type(e).__name__,
                        message=str(e)[:200],
                    )
            if "error" in reply:
                if _metrics.enabled():
                    _ins.RPC_SERVER_ERRORS_TOTAL.labels(verb).inc()
                _tracing.end_span(span, error_kind=reply.get("error_kind"))
            else:
                _tracing.end_span(span)
            try:
                # "oob": 1 in every reply envelope advertises protocol-5
                # support to the CLIENT, "ck": 1 checked-frame support
                # (rpc/integrity.py; old clients ignore unknown keys); the
                # reply frame itself only upgrades once this peer
                # advertised in a request envelope
                reply["oob"] = 1
                if _integrity.enabled():
                    reply["ck"] = 1
                with write_lock:
                    # under the dispatch span, closed by now
                    encode_span = None if span is None else _tracing.start_span(
                        _tracing.SPAN_RPC_ENCODE, parent_ctx=span.ctx(), method=verb,
                    )
                    try:
                        sent = send_frame(
                            conn, reply, oob=bool(peer and peer["oob"]),
                            checksum=bool(
                                peer and peer["ck"] and _integrity.enabled()
                            ),
                        )
                    finally:
                        _tracing.end_span(encode_span)
                if _metrics.enabled():
                    _ins.RPC_SERVER_SENT_BYTES_TOTAL.labels(verb).inc(sent)
            except OSError:
                pass  # peer went away; nothing to tell it
        finally:
            # t0 gates too: metrics toggled on mid-call must not observe
            # a bogus (now - 0.0) latency
            if verb is not None and t0 and _metrics.enabled():
                _ins.RPC_SERVER_REQUEST_SECONDS.labels(verb).observe(
                    time.monotonic() - t0
                )
            # the reply frame is on the wire: only now does the call stop
            # counting as in-flight (wait_idle gates process shutdown on this)
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until no dispatch is in flight (replies fully sent)."""
        with self._inflight_cv:
            return self._inflight_cv.wait_for(
                lambda: self._inflight == 0, timeout=timeout
            )

    def stop(self) -> None:
        """Close the listener (broker/broker.go:322, listener.Close). On
        Linux a close alone leaves a thread blocked in ``accept`` holding
        the listener, which then takes one more connection: the shutdown
        wakes it first."""
        self._stopped.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # never listened, or already shut
        try:
            self._sock.close()
        except OSError:
            pass
