"""End-to-end data integrity: digests, the checked-frame contract, the knob.

A copy of the JAX package's ``rpc/integrity.py`` (the port imports
nothing of that package), the shared vocabulary of three integrity planes:

* **Checked frames** (rpc/protocol.py): negotiated connections carry an
  in-header crc32 word covering the whole frame body — pickle bytes AND
  every out-of-band sidecar. A mismatch raises :class:`IntegrityError`
  before anything is parsed, and the connection is dropped like any
  malformed frame. Reference peers negotiate checksums by default, so the
  port speaks them to talk to one.
* **Halo cross-attestation** (rpc/worker.py + rpc/broker.py): resident
  strips carry state digests — a pre/post digest chain per strip per
  batch (an in-place corruption is caught on the very next ``StripStep``)
  and a rolling digest per side of the overlap band neighbouring workers
  compute redundantly in the shrinking batch form (a worker computing
  wrong rows near a boundary is caught in the same batch).
* **Verified checkpoints** (engine/checkpoint.py): blake2b-128 over
  geometry, turn, rule and board bytes.

crc32 guards the wire, adler32 (the ``state_*`` chain) the resident-strip
plane, which hashes every strip byte twice a batch, and blake2b-128
(``array_digest``) the tier that wants collision resistance. The hex of
every digest is the JAX package's, so a port worker attests to a
reference broker and the other way round.

``enabled()`` is the ``-integrity on|off`` knob (default ON): an off
process neither advertises checked frames nor computes attestations.
Checks only ever apply between peers that both advertised them.
"""

from __future__ import annotations

import hashlib
import struct
import zlib

import numpy as np

_CK = struct.Struct(">I")  # the in-header crc32 frame word
CK_WORD_SIZE = _CK.size

_enabled = True


def enabled() -> bool:
    """Whether this process checksums frames (the ``-integrity on|off``
    flag). ON by default."""
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


class IntegrityError(ConnectionError):
    """A checksum mismatch — data that must NOT be parsed. A
    ConnectionError, because nothing later on the stream can be trusted
    either, and every transport-failure path already treats
    ConnectionError as fatal for the peer."""


# zlib's crc32 and adler32 release the GIL for buffers above ~5 KiB, and
# reacquiring it under thread contention (an in-process worker cluster)
# can cost a scheduler quantum against the hash's microseconds. So every
# fold feeds the checksum in chunks below that threshold: exact, since
# both checksums are streaming.
_GIL_CHUNK = 4096


def _fold_chunked(fn, val: int, data) -> int:
    mv = memoryview(data)
    if mv.nbytes == 0:
        return val  # a 0-d/empty view cannot cast; folds to a no-op
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    if len(mv) <= _GIL_CHUNK:
        return fn(mv, val)
    for off in range(0, len(mv), _GIL_CHUNK):
        val = fn(mv[off:off + _GIL_CHUNK], val)
    return val


def crc_new() -> int:
    return 0


def crc_add(crc: int, data) -> int:
    """Fold one body piece (bytes/memoryview) into a running crc32."""
    return _fold_chunked(zlib.crc32, crc, data)


def crc_pack(crc: int) -> bytes:
    return _CK.pack(crc & 0xFFFFFFFF)


def crc_check(crc: int, word: bytes, what: str) -> None:
    """Verify a received crc word against the computed crc, loudly."""
    (want,) = _CK.unpack(word)
    if (crc & 0xFFFFFFFF) != want:
        raise IntegrityError(
            f"frame checksum mismatch on {what}: computed "
            f"{crc & 0xFFFFFFFF:#010x}, frame claims {want:#010x} — "
            "refusing to parse a corrupted frame"
        )


# -- state digests (the resident-strip attestation plane) --------------------
#
# adler32, rolled: each fold binds shape and dtype before the bytes so a
# reshaped or recast buffer with the same bytes cannot impersonate the
# original, and a zero-row band (the final shrinking step) still folds its
# header — defined and comparable.


def state_new() -> int:
    return zlib.adler32(b"")


def state_add(val: int, arr) -> int:
    """Fold one ndarray — shape, dtype, bytes — into a rolling state
    digest."""
    arr = np.ascontiguousarray(arr)
    val = zlib.adler32(f"{arr.shape}:{arr.dtype.str}:".encode(), val)
    return _fold_chunked(zlib.adler32, val, arr.data)


#: adler32's modulus
ADLER_MOD = 65521


def state_add_sums(val: int, shape, dtype, s1: int, s2: int) -> int:
    """``state_add`` of an array known only by its shape, dtype and byte
    sums: ``s1 = sum d_p`` and ``s2 = sum (n - p) d_p`` over its n bytes
    d_p in row-major order, each as is or reduced modulo 65521 (the strip
    kernel computes them on the card, ops/strip_steps.py). The header
    folds as ``state_add`` folds it; the bytes by zlib's combine
    arithmetic, a = a0 + s1 and b = b0 + n a0 + s2 modulo 65521, which
    is adler32 of the bytes bit for bit."""
    dtype = np.dtype(dtype)
    shape = tuple(int(d) for d in shape)
    val = zlib.adler32(f"{shape}:{dtype.str}:".encode(), val)
    n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    a0, b0 = val & 0xFFFF, (val >> 16) & 0xFFFF
    a = (a0 + int(s1)) % ADLER_MOD
    b = (b0 + n * a0 + int(s2)) % ADLER_MOD
    return (b << 16) | a


def state_hex(val: int) -> str:
    return f"{val & 0xFFFFFFFF:08x}"


def state_digest(arr) -> str:
    """One-shot state digest of a single ndarray — the pre/post strip
    chain links, the reply-edge digest, and the broker-side anchors the
    chain is seeded from and fetches are verified against."""
    return state_hex(state_add(state_new(), arr))


def array_digest(arr) -> str:
    """blake2b-128 hex digest of an ndarray's shape, dtype and bytes; the
    empty array digests to a well-defined constant."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{arr.shape}:{arr.dtype.str}:".encode())
    h.update(arr.data)
    return h.hexdigest()
