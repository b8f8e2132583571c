"""Frame checksums: the checked-frame contract of the wire, and its knob.

A copy of the framing part of the JAX package's ``rpc/integrity.py``
(the port imports nothing of that package). Negotiated connections carry
an in-header crc32 word covering the whole frame body — pickle bytes AND
every out-of-band sidecar (rpc/protocol.py). A mismatch raises
:class:`IntegrityError` before anything is parsed, and the connection is
dropped like any malformed frame. Reference peers negotiate checksums by
default, so the port speaks them to talk to one.

``enabled()`` is the ``-integrity on|off`` knob (default ON): an off
process neither advertises nor checks checked frames. Checks only ever
apply between peers that both advertised them.
"""

from __future__ import annotations

import struct
import zlib

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


# zlib's crc32 releases the GIL for buffers above ~5 KiB, and reacquiring
# it under thread contention can cost a scheduler quantum against the
# hash's microseconds. So every fold feeds the checksum in chunks below
# that threshold: exact, since crc32 is streaming.
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
