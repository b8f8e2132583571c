"""Minimal concurrent RPC server (the net/rpc role, broker/broker.go:284-285).

A copy of the JAX package's ``rpc/server.py`` without its metrics,
tracing and journal (the port has none of those yet). One
thread per connection and one per in-flight request, so a blocking
``Operations.Run`` never blocks ``Pause``/``Retrieve`` arriving on the
same or other connections, as Go net/rpc's goroutine-per-call model.
"""

from __future__ import annotations

import socket
import threading
import traceback

from . import faults as _faults
from . import integrity as _integrity
from .protocol import recv_frame_sized, send_frame

# structured error replies carry the remote traceback's tail (the raise
# site), truncated so a deep recursion cannot balloon an error frame
_TRACEBACK_LIMIT = 2000


class RpcServer:
    """Binds loopback by default: the transport is pickle-based, so
    exposure beyond the local host must be the operator's explicit choice
    (``host="0.0.0.0"`` / the -host flag), and even then frames only
    deserialise through the protocol allowlist."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._methods: dict = {}
        self._stopped = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._inflight = 0
        self._inflight_cv = threading.Condition()

    def register(self, name: str, fn) -> None:
        """Register a handler: fn(request) -> response object."""
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
            # reply frames are two writes; Nagle + delayed ACK would add
            # ~40-200 ms to every small reply
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        write_lock = threading.Lock()
        # per-connection protocol-5 + checksum capability: each flips once
        # the peer's envelope advertises it; an old client never does and
        # keeps getting plain frames
        peer = {"oob": False, "ck": False}
        try:
            while True:
                try:
                    msg, _ = recv_frame_sized(conn)
                except Exception:  # noqa: BLE001
                    # disconnect, forbidden global, truncated pickle or any
                    # other malformed frame: drop the peer — nothing more
                    # on this connection can be trusted
                    return
                threading.Thread(
                    target=self._dispatch, args=(conn, write_lock, msg, peer),
                    daemon=True,
                ).start()
        finally:
            conn.close()

    def _dispatch(self, conn, write_lock, msg, peer) -> None:
        with self._inflight_cv:
            self._inflight += 1
        try:
            # anything can be missing or of the wrong type in a frame that
            # passed the allowlist: an error reply whenever the frame named
            # a call id, a silent skip only when none is recoverable
            envelope = msg if isinstance(msg, dict) else {}
            if envelope.get("oob"):
                peer["oob"] = True
            if envelope.get("ck"):
                peer["ck"] = True
            call_id = envelope.get("id")
            if call_id is None:
                return  # not a call envelope: no reply is owed
            method = envelope.get("method")
            fn = self._methods.get(method) if isinstance(method, str) else None
            if fn is None:
                reply = {"id": call_id, "error": f"unknown method: {method!r}"}
            else:
                try:
                    # chaos hook (rpc/faults.py): GOL_FAULT_POINTS can turn
                    # any dispatch into a deterministic failure or wedge; a
                    # raise lands as an error reply like any handler's
                    _faults.fault_point("rpc.dispatch")
                    reply = {"id": call_id, "result": fn(envelope.get("request"))}
                except Exception as e:  # noqa: BLE001 — errors cross the wire, like net/rpc
                    reply = {
                        "id": call_id,
                        "error": f"{type(e).__name__}: {e}",
                        "error_kind": type(e).__name__,
                        "error_traceback": traceback.format_exc()[-_TRACEBACK_LIMIT:],
                    }
                    # machine-readable refusal reason (SessionRejected)
                    reason = getattr(e, "reason", None)
                    if isinstance(reason, str):
                        reply["error_reason"] = reason
            try:
                # every reply advertises protocol-5 ("oob") and, with
                # -integrity on, checked frames ("ck") to the client; the
                # reply itself upgrades only once the peer advertised
                reply["oob"] = 1
                if _integrity.enabled():
                    reply["ck"] = 1
                with write_lock:
                    send_frame(
                        conn, reply, oob=peer["oob"],
                        checksum=peer["ck"] and _integrity.enabled(),
                    )
            except OSError:
                pass  # peer went away; nothing to tell it
        finally:
            # the reply is on the wire: only now does the call stop
            # counting as in flight (wait_idle gates shutdown on this)
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until no dispatch is in flight (replies fully sent)."""
        with self._inflight_cv:
            return self._inflight_cv.wait_for(lambda: self._inflight == 0, timeout=timeout)

    def stop(self) -> None:
        """Close the listener (broker/broker.go:322, listener.Close)."""
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
