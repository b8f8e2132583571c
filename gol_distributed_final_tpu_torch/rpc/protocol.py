"""The RPC contract — the wire vocabulary between controller and broker.

A copy of the JAX package's ``rpc/protocol.py`` (the port imports nothing
of that package), wire-compatible with it in both directions. Method
names and wire-struct fields mirror the reference's stubs package
(stubs/stubs.go:5-38): Run blocks for the whole game, Retrieve snapshots,
Pause toggles, Quit detaches, SuperQuit shuts the broker down, SessionRun
is Run for one universe of a device-batched session table.

Transport is length-prefixed pickle frames over TCP, deserialised through
a restricted unpickler that resolves only the wire vocabulary: Request,
Response, Cell and numpy's array reconstruction.

The wire names are the JAX package's. Its unpickler allows exactly
``gol_distributed_final_tpu.rpc.protocol.{Request,Response}`` and
``gol_distributed_final_tpu.utils.cell.Cell``, so the port pickles its
own ``Request``, ``Response`` and ``Cell`` under those names (a pickler
that writes the global by name, without importing the module it names),
and its unpickler maps those names back onto the port's classes without
importing anything: a port process that reads a reference frame never
loads the JAX package, or jax.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import struct
from typing import List, Optional

import numpy as np

from ..obs import instruments as _ins
from ..obs import metrics as _metrics
from ..obs import tracing as _tracing
from ..utils.cell import Cell
from . import integrity as _integrity
from .integrity import CK_WORD_SIZE


class Methods:
    """Method-name constants of the broker's and the worker's verbs
    (stubs/stubs.go:5-11, plus the extensions)."""

    BROKER_RUN = "Operations.Run"
    RETRIEVE = "Operations.RetrieveCurrentData"
    PAUSE = "Operations.Pause"
    QUIT = "Operations.Quit"
    SUPER_QUIT = "Operations.SuperQuit"
    # read-only metrics snapshot (obs/): interrogate a running server
    # without touching the engine or the board. A broker answers it, a
    # worker answers WORKER_STATUS
    STATUS = "Operations.Status"
    # multi-universe serving (rpc/broker.SessionScheduler): Run's blocking
    # contract — evolve this world for req.turns and reply with the final
    # board — but many may be in flight at once, packed into one device
    # batch. A nonzero req.session_id tags the session so
    # RetrieveCurrentData with the same tag serves that universe.
    SESSION_RUN = "Operations.SessionRun"
    WORKER_UPDATE = "GameOfLifeOperations.Update"
    WORKER_QUIT = "GameOfLifeOperations.WorkerQuit"
    # a worker's Status; the broker's readmission probe asks it too
    WORKER_STATUS = "GameOfLifeOperations.Status"
    # the resident-strip data plane (-wire resident): the strip STAYS on
    # the worker across turns. StripStart seeds a strip at a turn,
    # StripStep advances K turns given depth-K halo rows (per-step alive
    # counts and fresh edge rows ride the reply), StripFetch reads the
    # strip and its turn back out (re-syncs, snapshots, loss recovery)
    STRIP_START = "GameOfLifeOperations.StripStart"
    STRIP_STEP = "GameOfLifeOperations.StripStep"
    STRIP_FETCH = "GameOfLifeOperations.StripFetch"


#: verbs whose handler blocks for the whole game by contract
BLOCKING_METHODS = frozenset({Methods.BROKER_RUN, Methods.SESSION_RUN})


@dataclasses.dataclass
class Request:
    """Mirror of stubs.Request (stubs/stubs.go:20-29) with the JAX
    package's extension fields, every one of them, so a frame round-trips
    between the two packages unchanged. Servers read the extensions with
    getattr: an older peer's pickle lacks them."""

    world: Optional[np.ndarray] = None
    turns: int = 0
    image_height: int = 0
    image_width: int = 0
    threads: int = 0
    start_y: int = 0
    end_y: int = 0
    worker: int = 0
    include_world: bool = True  # count-only Retrieve
    initial_turn: int = 0  # resume from a checkpoint
    rulestring: str = ""  # "" = the server's default rule
    halo_depth: int = 0  # mesh planes' halo depth; 0 = server default
    trace_ctx: Optional[dict] = None
    session_id: int = 0  # SessionRun / Retrieve tag; 0 = untagged
    timeline_since: int = 0
    accounting_since: int = 0
    delta_base_turn: int = -1
    hlc: Optional[list] = None
    journal_since: int = 0
    profile_since: int = 0
    grid_rows: int = 0
    grid_cols: int = 0
    start_x: int = 0
    end_x: int = 0


@dataclasses.dataclass
class Response:
    """Mirror of stubs.Response (stubs/stubs.go:31-38) with the JAX
    package's extension fields."""

    alive: Optional[List] = None
    alive_count: int = 0
    turns_completed: int = 0
    world: Optional[np.ndarray] = None
    work_slice: Optional[np.ndarray] = None
    worker: int = 0
    status: Optional[dict] = None
    trace_ctx: Optional[dict] = None
    edges: Optional[np.ndarray] = None
    counts: Optional[List] = None
    digests: Optional[dict] = None
    service_seconds: float = 0.0
    dirty: Optional[np.ndarray] = None
    hlc: Optional[list] = None


# -- the wire names -----------------------------------------------------------

_REF_PROTOCOL = "gol_distributed_final_tpu.rpc.protocol"
_REF_CELL = "gol_distributed_final_tpu.utils.cell"

#: port class -> the (module, name) global it travels under
WIRE_NAMES = {
    Request: (_REF_PROTOCOL, "Request"),
    Response: (_REF_PROTOCOL, "Response"),
    Cell: (_REF_CELL, "Cell"),
}
_WIRE_CLASSES = {name: cls for cls, name in WIRE_NAMES.items()}


class _WirePickler(pickle._Pickler):
    """The pure-Python pickler with the port's wire classes written under
    their reference names. The C pickler imports the module a global names
    to check it; this one writes the name as it is (protocol >= 4's
    STACK_GLOBAL) and memoizes the class like any global."""

    def save_global(self, obj, name=None):
        wire = WIRE_NAMES.get(obj) if isinstance(obj, type) else None
        if wire is None:
            return super().save_global(obj, name)
        module, qualname = wire
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def dumps(obj, buffer_callback=None) -> bytes:
    """Pickle ``obj`` (protocol 5) with the wire names."""
    out = io.BytesIO()
    _WirePickler(out, protocol=5, buffer_callback=buffer_callback).dump(obj)
    return out.getvalue()


# -- deserialisation allowlist ------------------------------------------------

# numpy's array/scalar reconstruction (module path differs across numpy
# 1.x/2.x); resolved by importing numpy, which the port has anyway
_NUMPY_GLOBALS = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    # protocol-5 contiguous-array path (what the wire actually uses)
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("_codecs", "encode"),  # numpy string-dtype reconstruction (proto <= 2)
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _WIRE_CLASSES.get((module, name))
        if cls is not None:
            return cls  # by name: the module it names is never imported
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"frame references forbidden global {module}.{name}"
        )


def loads_restricted(payload: bytes, buffers=None):
    """``buffers`` is the protocol-5 out-of-band sidecar list (in frame
    order): each ndarray pickled out-of-band reconstructs as a view of
    its sidecar buffer. Same allowlist either way."""
    return _RestrictedUnpickler(io.BytesIO(payload), buffers=buffers).load()


# -- framing ------------------------------------------------------------------
#
# The JAX package's three frame shapes, sharing one 8-byte big-endian
# header word:
#
# * plain: header = payload length, payload = one pickle (ndarrays
#   in-band). The only shape an un-negotiated peer ever receives.
# * out-of-band (protocol 5): header = _FLAG_OOB | body length, body =
#   [>IQ nbufs,pickle_len][>Q buf_len x nbufs][pickle][raw buffers...];
#   every ndarray >= _OOB_THRESHOLD travels as a raw sidecar after the
#   pickle, sent from the array's own memory and received straight into
#   the buffer the unpickled array wraps.
# * checked (bit 62): a 4-byte crc32 word over every body byte rides right
#   after the length word, in the same write as the header; the receiver
#   verifies it BEFORE anything is unpickled.
#
# Both flags are negotiated per transport ("oob": 1 / "ck": 1 in the
# envelopes), so a peer only receives a shape it advertised.

_HEADER = struct.Struct(">Q")
MAX_FRAME = 1 << 34  # 16 GiB: a 65536^2 board is ~4 GiB
_FLAG_OOB = 1 << 63
_FLAG_CK = 1 << 62
_LEN_MASK = _FLAG_CK - 1
_OOB_SUB = struct.Struct(">IQ")  # (nbufs, pickle_len)
_OOB_LEN = struct.Struct(">Q")  # one sidecar buffer's length
# below this a buffer stays in-band: two syscalls and a subheader entry
# cost more than copying a few hundred bytes into the pickle
_OOB_THRESHOLD = 1024
# a hostile subheader must not make the receiver allocate an unbounded list
_MAX_OOB_BUFFERS = 4096


def send_frame(sock, obj, oob: bool = False, checksum: bool = False) -> int:
    """Callers serialise sends per socket (RpcClient and RpcServer hold a
    write lock). Returns the frame size in bytes (header + payload).
    ``oob`` selects the protocol-5 out-of-band shape, ``checksum`` the
    checked shape; either asserts the peer advertised it."""
    if not oob:
        payload = dumps(obj)
        if checksum:
            head = _HEADER.pack(_FLAG_CK | len(payload)) + _integrity.crc_pack(
                _integrity.crc_add(0, payload)
            )
        else:
            head = _HEADER.pack(len(payload))
        sock.sendall(head)
        sock.sendall(payload)
        return len(head) + len(payload)
    raws = []

    def _sidecar(pb: pickle.PickleBuffer):
        raw = pb.raw()
        if raw.nbytes < _OOB_THRESHOLD:
            return True  # truthy: pickle keeps it in-band
        raws.append(raw)
        return False  # falsy: out-of-band, sent below

    payload = dumps(obj, buffer_callback=_sidecar)
    sub = _OOB_SUB.pack(len(raws), len(payload)) + b"".join(
        _OOB_LEN.pack(r.nbytes) for r in raws
    )
    total = len(sub) + len(payload) + sum(r.nbytes for r in raws)
    if checksum:
        crc = _integrity.crc_add(_integrity.crc_add(0, sub), payload)
        for raw in raws:
            crc = _integrity.crc_add(crc, raw)
        head = _HEADER.pack(_FLAG_OOB | _FLAG_CK | total) + _integrity.crc_pack(crc)
    else:
        head = _HEADER.pack(_FLAG_OOB | total)
    sock.sendall(head)
    sock.sendall(sub)
    sock.sendall(payload)
    for raw in raws:
        sock.sendall(raw)  # the array's own memory: zero-copy send
    return len(head) + total


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed the connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_into_exact(sock, buf) -> None:
    view = memoryview(buf)
    got = 0
    while got < len(view):
        n = sock.recv_into(view[got:])
        if not n:
            raise ConnectionError("peer closed the connection")
        got += n


def _verify_crc(want: bytes, crc: int, what: str) -> None:
    """Verify the computed body crc against the frame's crc word — the
    checked-frame gate: on mismatch the frame is never parsed and the
    stream never trusted again (IntegrityError is a ConnectionError).
    Counted either way."""
    if _metrics.enabled():
        _ins.INTEGRITY_CHECKS_TOTAL.inc()
    try:
        _integrity.crc_check(crc, want, what)
    except _integrity.IntegrityError:
        _ins.INTEGRITY_FAILURES_TOTAL.labels("frame").inc()
        raise


def recv_frame_sized(sock, body_began: Optional[list] = None):
    """``(obj, frame_bytes)``. With the tracer on, a ``body_began`` list
    gets the span clock's reading (obs/tracing.py's ``now_ns``) once the
    header has arrived: where the body's receive and unpickle, the
    ``rpc.decode`` span, begin."""
    # one 12-byte first read: a checked frame's crc word rides right
    # behind the length word; for an unchecked frame the surplus is the
    # body's first bytes, consumed below
    head = b""
    while len(head) < _HEADER.size:
        chunk = sock.recv(_HEADER.size + CK_WORD_SIZE - len(head))
        if not chunk:
            raise ConnectionError("peer closed the connection")
        head += chunk
    if body_began is not None and _tracing.enabled():
        body_began.append(_tracing.now_ns())
    (word,) = _HEADER.unpack(head[:_HEADER.size])
    extra = head[_HEADER.size:]
    length = word & _LEN_MASK
    checked = bool(word & _FLAG_CK)
    if length > MAX_FRAME:
        raise ConnectionError(f"frame of {length} bytes exceeds limit")
    if checked:
        if len(extra) < CK_WORD_SIZE:
            extra += _recv_exact(sock, CK_WORD_SIZE - len(extra))
        want, pre = extra, b""
    else:
        want, pre = b"", extra
        if len(pre) > length:
            # no real pickle is under 4 bytes: a mis-framed stream
            raise ConnectionError(f"implausibly short frame ({length} B)")
    head_len = _HEADER.size + (CK_WORD_SIZE if checked else 0)
    if not word & _FLAG_OOB:
        payload = pre + _recv_exact(sock, length - len(pre))
        if checked:
            _verify_crc(want, _integrity.crc_add(0, payload), "pickle body")
        return loads_restricted(payload), head_len + length
    # out-of-band: every subheader quantity is validated against the
    # framed length BEFORE any allocation on its say-so
    if length < _OOB_SUB.size:
        raise ConnectionError("out-of-band frame shorter than its subheader")
    sub = pre + _recv_exact(sock, _OOB_SUB.size - len(pre))
    nbufs, pickle_len = _OOB_SUB.unpack(sub)
    if nbufs > _MAX_OOB_BUFFERS:
        raise ConnectionError(f"frame claims {nbufs} sidecar buffers")
    lens_blob = _recv_exact(sock, _OOB_LEN.size * nbufs)
    buf_lens = [
        _OOB_LEN.unpack_from(lens_blob, i * _OOB_LEN.size)[0] for i in range(nbufs)
    ]
    if _OOB_SUB.size + _OOB_LEN.size * nbufs + pickle_len + sum(buf_lens) != length:
        raise ConnectionError("out-of-band frame length mismatch")
    payload = _recv_exact(sock, pickle_len)
    crc = 0
    if checked:
        crc = _integrity.crc_add(
            _integrity.crc_add(_integrity.crc_add(0, sub), lens_blob), payload
        )
    buffers = []
    for n in buf_lens:
        buf = bytearray(n)
        _recv_into_exact(sock, buf)
        if checked:
            crc = _integrity.crc_add(crc, buf)
        buffers.append(buf)
    if checked:
        # verified BEFORE the unpickle wraps any sidecar
        _verify_crc(want, crc, f"body + {nbufs} sidecar(s)")
    return loads_restricted(payload, buffers), head_len + length


def recv_frame(sock):
    return recv_frame_sized(sock)[0]

