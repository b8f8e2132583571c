"""Checkpoint and resume: the board, the turn counter and the rule, so a run
continues exactly where it stopped.

The reference's only snapshot is the PGM that 's' writes
(gol/distributor.go:78-90), and a run always starts at turn 0. The JAX
package added checkpoints; this module keeps its files byte for byte, so a
checkpoint written by either package loads, verifies and resumes in the
other:

* the byte format, a ``.npz`` with ``board`` (uint8 [H, W]), ``turn``,
  ``rulestring`` and (format v2) ``format_version`` and ``digest``, a
  blake2b-128 over geometry, turn, rule and board bytes, so a truncated,
  corrupt or mislabelled file is a typed :class:`CheckpointError` at load
  time instead of a wrong resume;
* generations (``-ckpt-keep``): ``<stem>.g<N>.npz`` beside the newest, and
  :func:`load_resume_checkpoint` falls back to the newest that verifies;
* delta checkpoints: the dirty tiles (ops/sparse.py) of a board against a
  full generation, with the base's digest and the result's;
* the packed format, the int32 bitboard as it lies on the card
  (``packed``, ``word_axis``, ``turn``, ``rulestring``): a 65536^2 board
  is 512 MiB packed and 4 GiB as bytes.

The ``-resume`` surfaces load through :func:`load_verified_checkpoint` or
:func:`load_resume_checkpoint`; :func:`load_checkpoint` stays lenient for
callers that accept files without a digest. Every verification attempt,
of a full file or a delta, is counted on ``gol_ckpt_verify_total{result}``
and journalled (``ckpt.verify``), and a resume journals what it replayed
(``ckpt.replay``), as in the JAX package.

A bitboard sharded over several processes (parallel/mesh.ShardedBoard)
checkpoints as one file per rank, ``<stem>.rank<k>of<n>.npz``, each
holding that rank's word rows (:func:`save_packed_checkpoint_sharded`);
the ranks load their own and agree on the turn before any resumes
(:func:`load_packed_checkpoint_sharded`).
"""

from __future__ import annotations

import hashlib
import pathlib
import re
from typing import Optional

import numpy as np
import torch

from ..models import CONWAY, LifeRule
from ..obs import flight as _flight
from ..obs import instruments as _ins
from ..obs import journal as _journal

CKPT_FORMAT_VERSION = 2


class CheckpointError(ValueError):
    """A checkpoint that must not be resumed from. ``kind`` narrows the
    failure: ``unreadable`` (not an npz, or a truncated zip), ``truncated``
    (an npz missing checkpoint fields), ``format`` (a packed file on the
    byte surface, or a newer format), ``unverified`` (no embedded digest),
    ``digest`` (contents do not hash to the embedded digest),
    ``delta-base`` (a delta cut against another base), ``exhausted``
    (every ``-ckpt-keep`` generation failed). The message says what to do
    next."""

    def __init__(self, message: str, kind: str = "corrupt"):
        super().__init__(message)
        self.kind = kind


def checkpoint_digest(
    board, turn: int, rulestring: str, format_version: int = CKPT_FORMAT_VERSION,
) -> str:
    """blake2b-128 hex digest binding the board bytes to geometry, turn and
    rule. ``format_version`` is the one stamped in the file being written or
    verified, so a version bump does not turn existing files into digest
    failures."""
    board = np.ascontiguousarray(board, np.uint8)
    h = hashlib.blake2b(digest_size=16)
    h.update(
        f"gol-ckpt:v{int(format_version)}:{board.shape[0]}x{board.shape[1]}"
        f":{int(turn)}:{rulestring}:".encode()
    )
    h.update(board.data)
    return h.hexdigest()


def npz_path(path) -> pathlib.Path:
    """The path ``np.savez_compressed`` writes: ``.npz`` is appended unless
    the name already ends with it."""
    path = pathlib.Path(path)
    return path if path.suffix == ".npz" else path.with_name(path.name + ".npz")


def _save_npz(path, **arrays) -> pathlib.Path:
    """Write a compressed npz; returns the path written."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    return npz_path(path)


def save_checkpoint(path, world, turn: int, rule: LifeRule = CONWAY) -> pathlib.Path:
    board = np.asarray(world, np.uint8)
    return _save_npz(
        path,
        board=board,
        turn=np.int64(turn),
        rulestring=np.str_(rule.rulestring),
        format_version=np.int64(CKPT_FORMAT_VERSION),
        digest=np.str_(checkpoint_digest(board, turn, rule.rulestring)),
    )


def load_checkpoint(path) -> tuple[np.ndarray, int, LifeRule]:
    with np.load(path, allow_pickle=False) as data:
        if "packed" in data:
            raise ValueError(
                f"{path} is a packed-bitboard checkpoint; use "
                "load_packed_checkpoint (unpacking a big board to bytes "
                "would build 32x the state on the host)"
            )
        board = data["board"].astype(np.uint8)
        turn = int(data["turn"])
        rule = LifeRule.from_rulestring(str(data["rulestring"]))
    return board, turn, rule


def _load_for_verification(path) -> tuple[np.ndarray, int, LifeRule, Optional[str], int]:
    """The typed-error load: every way an npz can be wrong becomes a
    CheckpointError, never a raw zipfile, KeyError or ValueError."""
    path = pathlib.Path(path)
    try:
        with np.load(path, allow_pickle=False) as data:
            if "packed" in data:
                raise CheckpointError(
                    f"{path} is a packed-bitboard checkpoint; the -resume "
                    "surface takes byte checkpoints (the bigboard surface "
                    "loads packed ones)",
                    kind="format",
                )
            missing = [k for k in ("board", "turn", "rulestring") if k not in data]
            if missing:
                raise CheckpointError(
                    f"{path} is missing checkpoint field(s) "
                    f"{', '.join(missing)}: not a checkpoint, or one cut "
                    "short mid-write — fall back to an older generation "
                    "(-ckpt-keep) or start the run fresh",
                    kind="truncated",
                )
            board = data["board"].astype(np.uint8)
            turn = int(data["turn"])
            rulestring = str(data["rulestring"])
            stored = str(data["digest"]) if "digest" in data else None
            # the version the file claims; digests began at v2
            version = (
                int(data["format_version"])
                if "format_version" in data else CKPT_FORMAT_VERSION
            )
    except CheckpointError:
        raise
    except Exception as exc:
        raise CheckpointError(
            f"{path} is not a readable checkpoint "
            f"({type(exc).__name__}: {exc}): the file is truncated or "
            "corrupt — fall back to an older generation (-ckpt-keep) or "
            "start the run fresh",
            kind="unreadable",
        ) from exc
    try:
        rule = LifeRule.from_rulestring(rulestring)
    except ValueError as exc:
        raise CheckpointError(
            f"{path} carries an unparseable rulestring {rulestring!r}: {exc}",
            kind="truncated",
        ) from exc
    return board, turn, rule, stored, version


def _metered_verify(path, load):
    """Run ``load()``, a verification of ``path`` returning ``(board, turn,
    ...)``, counting and journalling its outcome."""
    try:
        result = load()
    except CheckpointError as exc:
        _ins.CKPT_VERIFY_TOTAL.labels("fail").inc()
        _journal.record("ckpt.verify", "fail", path=str(path), kind=exc.kind)
        raise
    _ins.CKPT_VERIFY_TOTAL.labels("ok").inc()
    _journal.record("ckpt.verify", "ok", path=str(path), turn=result[1])
    return result


def load_verified_checkpoint(path) -> tuple[np.ndarray, int, LifeRule]:
    """``load_checkpoint`` with the integrity contract: the file must carry
    a digest and its contents must hash to it, else a typed
    :class:`CheckpointError` — a resume never reattaches state it cannot
    verify. Every attempt is counted (``gol_ckpt_verify_total{result}``)."""
    return _metered_verify(path, lambda: _load_verified(path))


def _load_verified(path) -> tuple[np.ndarray, int, LifeRule]:
    board, turn, rule, stored, version = _load_for_verification(path)
    if stored is None:
        raise CheckpointError(
            f"{path} carries no integrity digest (written by a "
            "pre-integrity version): -resume refuses unverified "
            "state; load it explicitly with load_checkpoint() if you "
            "accept the risk",
            kind="unverified",
        )
    if version > CKPT_FORMAT_VERSION:
        raise CheckpointError(
            f"{path} is a format-v{version} checkpoint but this "
            f"build verifies up to v{CKPT_FORMAT_VERSION}: load it "
            "with the version that wrote it",
            kind="format",
        )
    if checkpoint_digest(board, turn, rule.rulestring, version) != stored:
        raise CheckpointError(
            f"{path} failed digest verification: board/turn/rule do "
            "not hash to the embedded digest — the file is corrupt; "
            "fall back to an older generation (-ckpt-keep)",
            kind="digest",
        )
    return board, turn, rule


def write_checkpoint(
    path, turn: int, rule: LifeRule, *, board=None, packed=None, word_axis: int = 0,
) -> pathlib.Path:
    """Write a checkpoint under a temporary name and rename it over
    ``npz_path(path)``, so a crash mid-write leaves the previous one whole:
    the packed format when ``packed`` (int32 words, on the host or the
    card) is given, else the byte format of ``board``."""
    tmp = pathlib.Path(path)
    tmp = tmp.with_name(tmp.name + ".tmp")
    if packed is not None:
        written = save_packed_checkpoint(tmp, packed, turn, rule, word_axis)
    else:
        written = save_checkpoint(tmp, board, turn, rule)
    return written.replace(npz_path(path))


def try_write_checkpoint(path, turn: int, rule: LifeRule, plane, state) -> Optional[Exception]:
    """The engine's periodic checkpoint of a plane's ``state``: packed for
    a bitboard plane (one with a ``word_axis``) whose state is a tensor of
    int32 words, the byte format of ``plane.decode(state)`` otherwise (a
    ``SparseState`` among them, as the JAX engine writes it). Returns the failure,
    of any type, instead of raising it, the host copy and the decode
    included: a full disk or a host buffer that cannot be had must not end
    the run the checkpoint protects (the engine surfaces it on
    ``RunResult.checkpoint_error``)."""
    word_axis = getattr(plane, "word_axis", None)
    try:
        if word_axis is not None and hasattr(state, "blocks"):
            # a fully addressable mesh state: the one-host packed format
            write_checkpoint(path, turn, rule, packed=state.gather(), word_axis=word_axis)
        elif (word_axis is not None and isinstance(state, torch.Tensor)
                and state.dtype == torch.int32):
            write_checkpoint(path, turn, rule, packed=state, word_axis=word_axis)
        else:
            write_checkpoint(path, turn, rule, board=plane.decode(state))
    except Exception as exc:  # noqa: BLE001 — reported by the caller
        return exc
    return None


def try_write_checkpoint_sharded(path, turn: int, rule: LifeRule, plane, state) -> Optional[Exception]:
    """The engine's periodic checkpoint of a state sharded over several
    processes: each rank writes its own shard, then the ranks vote with an
    all-gather, so a failure on any rank comes back as a failure on every
    rank and the mixed shard set it leaves is never taken for a success.
    Every rank reaches this at the same turn (the chunking is agreed), and
    a rank's own failure is caught before the vote: raising first would
    strand its peers inside the collective. Returns the failure, or None."""
    from ..parallel.multihost import allgather

    ok, err = 1, None
    try:
        save_packed_checkpoint_sharded(path, state, turn, rule, plane.word_axis)
    except Exception as exc:  # noqa: BLE001 — voted on, then returned
        ok, err = 0, exc
    # the vote, recorded before the collective: if a peer never shows up,
    # every surviving rank's flight ring names this crossing as its last act
    _flight.record("ckpt.vote", "checkpoint_agreement", turn=turn, ok=bool(ok))
    oks = allgather(np.array([ok], np.int64))
    failed = int(len(oks) - oks.sum())
    _flight.record(
        "ckpt.agree", "checkpoint_agreement", turn=turn, failed_ranks=failed,
    )
    if failed and err is None:
        err = OSError(
            f"checkpoint at turn {turn}: shard write failed on {failed} other "
            "rank(s); the on-disk set is mixed until the next successful crossing"
        )
    return err


def generation_path(path, gen: int) -> pathlib.Path:
    """Where generation ``gen`` of a rotated checkpoint lives: gen 0 is the
    configured path itself, gen N is ``<stem>.gN.npz`` beside it (g1 is
    the previous current)."""
    p = npz_path(path)
    return p if gen == 0 else p.with_name(f"{p.stem}.g{gen}.npz")


def rotate_generations(path, keep: int) -> None:
    """Shift the chain down one slot before a new current is written:
    current → .g1 → .g2 → …, keeping at most ``keep`` generations. A
    missing link only shortens the chain."""
    if keep <= 1:
        return
    for gen in range(keep - 2, -1, -1):
        src = generation_path(path, gen)
        if src.exists():
            src.replace(generation_path(path, gen + 1))


def load_resume_checkpoint(path, keep: int = 1) -> tuple[np.ndarray, int, LifeRule, int]:
    """The ``-resume`` loader: the newest verifiable generation of ``path``
    → ``(board, turn, rule, generation)``. Tries gen 0 … keep-1 in order,
    falls back past unverifiable files, and raises a CheckpointError
    listing every attempt when none verifies: resuming from nothing is an
    operator's decision, never a silent run from turn 0.

    Verified delta checkpoints newer than the chosen generation advance the
    resume point, the newest that applies and verifies first; a corrupt or
    mismatched delta is skipped (every delta applies to its full keyframe,
    so skipping one only costs its turns)."""
    attempts = []
    for gen in range(max(1, keep)):
        p = generation_path(path, gen)
        if not p.exists():
            raw = pathlib.Path(path)
            if gen == 0 and raw.exists():
                p = raw  # an explicit path without the .npz suffix
            else:
                attempts.append(f"{p}: not found")
                continue
        try:
            board, turn, rule = load_verified_checkpoint(p)
        except CheckpointError as exc:
            attempts.append(f"{p}: [{exc.kind}] {exc}")
            continue
        for dturn, dpath in reversed(delta_checkpoint_paths(path)):
            if dturn <= turn:
                break
            try:
                board_d, turn_d = apply_delta_checkpoint(dpath, board, turn, rule)
            except CheckpointError as exc:
                attempts.append(f"{dpath}: [{exc.kind}] {exc}")
                continue
            _journal.record(
                "ckpt.replay", "delta", turn=turn_d, gen=gen, base_turn=turn,
            )
            return board_d, turn_d, rule, gen
        _journal.record("ckpt.replay", "full", turn=turn, gen=gen)
        return board, turn, rule, gen
    raise CheckpointError(
        "no verifiable checkpoint generation to resume from:\n  "
        + "\n  ".join(attempts),
        kind="exhausted",
    )


# -- delta checkpoints: the dirty tiles since the last full generation -------
#
# Between full keyframes only the tiles that changed since the last FULL
# checkpoint are written, so every delta applies directly onto its keyframe
# (never a delta on a delta). The file embeds the digest of the base it
# applies to and of the board it must produce: a wrong base, a flipped tile
# byte or a truncated payload is a typed refusal at load time.


def delta_checkpoint_path(path, turn: int) -> pathlib.Path:
    """Where the delta at ``turn`` lives: ``<stem>.d<turn>.npz`` beside the
    full checkpoint."""
    p = npz_path(path)
    return p.with_name(f"{p.stem}.d{int(turn)}.npz")


def delta_checkpoint_paths(path) -> list[tuple[int, pathlib.Path]]:
    """The delta files of a checkpoint path as ``(turn, path)``, by turn."""
    p = npz_path(path)
    pat = re.compile(re.escape(p.stem) + r"\.d(\d+)\.npz$")
    out = []
    for cand in p.parent.glob(f"{p.stem}.d*.npz"):
        m = pat.match(cand.name)
        if m:
            out.append((int(m.group(1)), cand))
    return sorted(out)


def clear_delta_checkpoints(path) -> None:
    """Drop every delta beside ``path``, when a new full keyframe lands.
    Best-effort: a stale delta is refused by its base digest anyway."""
    for _turn, p in delta_checkpoint_paths(path):
        try:
            p.unlink()
        except OSError:
            pass


def save_delta_checkpoint(
    path,
    board,
    dirty: np.ndarray,
    turn: int,
    rule: LifeRule,
    base_turn: int,
    base_digest: str,
) -> pathlib.Path:
    """Write the dirty tiles of ``board`` as a delta against the full
    checkpoint whose board hashed to ``base_digest`` at ``base_turn``,
    under a temporary name renamed into place."""
    from ..ops.sparse import extract_dirty_tiles, wire_tile_grid

    board = np.asarray(board, np.uint8)
    dirty = np.asarray(dirty, bool)
    if dirty.shape != wire_tile_grid(board.shape):
        raise ValueError(
            f"dirty grid {dirty.shape} does not match board "
            f"{board.shape}'s wire-tile grid"
        )
    final = delta_checkpoint_path(path, turn)
    written = _save_npz(
        final.with_name(final.name + ".tmp"),
        dirty=dirty,
        tiles=extract_dirty_tiles(board, dirty),
        height=np.int64(board.shape[0]),
        width=np.int64(board.shape[1]),
        turn=np.int64(turn),
        base_turn=np.int64(base_turn),
        base_digest=np.str_(base_digest),
        rulestring=np.str_(rule.rulestring),
        format_version=np.int64(CKPT_FORMAT_VERSION),
        digest=np.str_(checkpoint_digest(board, turn, rule.rulestring)),
    )
    written.replace(final)
    return final


_DELTA_FIELDS = (
    "dirty", "tiles", "height", "width", "turn", "base_turn", "base_digest",
    "rulestring", "digest",
)


def apply_delta_checkpoint(
    path, base_board: np.ndarray, base_turn: int, rule: LifeRule
) -> tuple[np.ndarray, int]:
    """Apply one delta file onto its verified base → ``(board, turn)``.
    Raises a typed CheckpointError when the base is not the one the delta
    was cut against, when the payload is malformed, or when the result
    does not hash to the embedded digest. Every attempt is counted
    (``gol_ckpt_verify_total{result}``)."""
    return _metered_verify(
        path, lambda: _apply_delta(pathlib.Path(path), base_board, base_turn, rule)
    )


def _apply_delta(path, base_board, base_turn: int, rule: LifeRule) -> tuple[np.ndarray, int]:
    from ..ops.sparse import apply_dirty_tiles

    try:
        with np.load(path, allow_pickle=False) as data:
            missing = [k for k in _DELTA_FIELDS if k not in data]
            if missing:
                raise CheckpointError(
                    f"{path} is missing delta field(s) {', '.join(missing)}: "
                    "not a delta checkpoint, or one cut short mid-write",
                    kind="truncated",
                )
            dirty = np.asarray(data["dirty"], bool)
            tiles = np.asarray(data["tiles"], np.uint8)
            shape = (int(data["height"]), int(data["width"]))
            turn = int(data["turn"])
            d_base_turn = int(data["base_turn"])
            base_digest = str(data["base_digest"])
            rulestring = str(data["rulestring"])
            stored = str(data["digest"])
            version = (
                int(data["format_version"])
                if "format_version" in data else CKPT_FORMAT_VERSION
            )
    except CheckpointError:
        raise
    except Exception as exc:
        raise CheckpointError(
            f"{path} is not a readable delta checkpoint "
            f"({type(exc).__name__}: {exc})",
            kind="unreadable",
        ) from exc
    if rulestring != rule.rulestring:
        raise CheckpointError(
            f"{path} is a {rulestring} delta applied to a {rule.rulestring} base",
            kind="format",
        )
    base_board = np.asarray(base_board, np.uint8)
    if shape != base_board.shape or d_base_turn != base_turn:
        raise CheckpointError(
            f"{path} was cut against a {shape} board at turn "
            f"{d_base_turn}, not this {base_board.shape} base at "
            f"turn {base_turn}", kind="delta-base",
        )
    if checkpoint_digest(base_board, base_turn, rulestring, version) != base_digest:
        raise CheckpointError(
            f"{path}: the base board does not hash to the delta's "
            "embedded base digest — it applies to a different full "
            "generation", kind="delta-base",
        )
    try:
        board = apply_dirty_tiles(base_board, dirty, tiles)
    except ValueError as exc:
        raise CheckpointError(
            f"{path}: malformed delta payload ({exc})", kind="truncated",
        ) from exc
    if checkpoint_digest(board, turn, rulestring, version) != stored:
        raise CheckpointError(
            f"{path} failed digest verification: the applied board "
            "does not hash to the embedded digest — the delta is "
            "corrupt; resume falls back to the full generation",
            kind="digest",
        )
    return board, turn


# -- packed checkpoints: the bitboard as it lies on the card ------------------


def save_packed_checkpoint(
    path, packed, turn: int, rule: LifeRule = CONWAY, word_axis: int = 0
) -> pathlib.Path:
    """Checkpoint a bitboard without decoding it: the int32 words cross to
    the host once (``.cpu()`` for a tensor on the card) and land compressed
    on disk."""
    if hasattr(packed, "cpu"):
        packed = packed.cpu().numpy()
    return _save_npz(
        path,
        packed=np.asarray(packed, np.int32),
        word_axis=np.int64(word_axis),
        turn=np.int64(turn),
        rulestring=np.str_(rule.rulestring),
    )


def load_packed_checkpoint(path) -> tuple[np.ndarray, int, LifeRule, int]:
    """→ ``(packed int32 array, turn, rule, word_axis)``: the byte loader's
    ``(board, turn, rule)`` with ``word_axis`` appended. The words come
    back on the host; ``ops/bitpack.state_from_numpy`` puts them on a
    device."""
    with np.load(path, allow_pickle=False) as data:
        if "packed" not in data:
            raise ValueError(f"{path} is a byte-board checkpoint; use load_checkpoint")
        packed = data["packed"].astype(np.int32)
        word_axis = int(data["word_axis"])
        turn = int(data["turn"])
        rule = LifeRule.from_rulestring(str(data["rulestring"]))
    return packed, turn, rule, word_axis


# -- sharded packed checkpoints: one file per rank ------------------------------


def checkpoint_shard_path(path, rank: int, num_processes: int) -> pathlib.Path:
    """Where rank ``rank``'s shard of a multi-process checkpoint lives:
    ``<stem>.rank<k>of<n>.npz`` next to the configured path. Works on a
    shared filesystem (all shards side by side) and on per-host disks
    (each rank only ever touches its own name)."""
    p = npz_path(path)
    return p.with_name(f"{p.stem}.rank{rank}of{num_processes}.npz")


def local_packed_rows(state) -> tuple[int, np.ndarray]:
    """This process's contiguous block of packed word rows, assembled from
    its blocks of a ``ShardedBoard`` -> ``(first_global_row, rows)``.
    Raises unless the process owns whole contiguous mesh rows (the
    canonical process-major placement)."""
    row0, rows = state.local_rows()
    return row0, rows.cpu().numpy()


def save_packed_checkpoint_sharded(
    path, state, turn: int, rule: LifeRule = CONWAY, word_axis: int = 0
) -> pathlib.Path:
    """One checkpoint shard per process for a mesh-sharded bitboard: each
    rank writes ONLY its own word rows, under a temporary name renamed
    into place. Every shard stamps the turn, rule, global shape and
    process count, so the loader can refuse a mismatched reassembly. The
    files are the JAX package's, byte for byte."""
    from ..parallel.multihost import process_count, process_index

    rank, nprocs = process_index(), process_count()
    row0, rows = local_packed_rows(state)
    final = checkpoint_shard_path(path, rank, nprocs)
    tmp = final.with_name(final.name + ".tmp")
    written = _save_npz(
        tmp,
        packed=rows,
        row0=np.int64(row0),
        global_rows=np.int64(state.shape[0]),
        global_cols=np.int64(state.shape[1]),
        num_processes=np.int64(nprocs),
        process_index=np.int64(rank),
        word_axis=np.int64(word_axis),
        turn=np.int64(turn),
        rulestring=np.str_(rule.rulestring),
    )
    written.replace(final)
    return final


def load_packed_checkpoint_sharded(path, sharding):
    """Each rank loads ITS shard of a multi-process packed checkpoint and
    places it on the mesh -> ``(ShardedBoard, turn, rule, word_axis)``.

    ``sharding`` is the target placement (parallel/bit_halo
    ``packed_sharding(mesh)``). Checks that the shard was written by a job
    of the same process count, that its row offset is where this rank's
    blocks start, and (through the global shape) that the geometry is
    unchanged. Collective in a multi-process job: every rank reaches the
    all-gather of an (ok, turn) word, its own failure caught rather than
    raised before it (a rank raising early would strand its peers inside
    the collective), and a mixed set of turns is refused on every rank. A
    one-process job also reads the one-host packed format."""
    from ..parallel.mesh import ShardedBoard
    from ..parallel.multihost import allgather, process_count, process_index

    mesh = sharding.mesh
    rank, nprocs = process_index(), process_count()
    p = checkpoint_shard_path(path, rank, nprocs)
    if nprocs == 1 and not p.exists() and npz_path(path).exists():
        packed, turn, rule, word_axis = load_packed_checkpoint(npz_path(path))
        return ShardedBoard.from_global(mesh, packed), turn, rule, word_axis
    err = None
    rows = turn = rule = word_axis = gshape = None
    try:
        with np.load(p, allow_pickle=False) as data:
            if "packed" not in data or "row0" not in data:
                raise ValueError(f"{p} is not a sharded packed checkpoint")
            if int(data["num_processes"]) != nprocs:
                raise ValueError(
                    f"{p} was written by {int(data['num_processes'])} "
                    f"processes; this job has {nprocs}"
                )
            rows = data["packed"].astype(np.int32)
            row0 = int(data["row0"])
            word_axis = int(data["word_axis"])
            turn = int(data["turn"])
            rule = LifeRule.from_rulestring(str(data["rulestring"]))
            gshape = (int(data["global_rows"]), int(data["global_cols"]))
        bh, _ = sharding.block_shape(gshape)
        want_row0 = min(i for i, _ in mesh.local_slots()) * bh
        if row0 != want_row0:
            raise ValueError(
                f"shard {p} holds rows from {row0} but this rank's mesh "
                f"placement starts at {want_row0}: process/mesh order "
                "changed since the checkpoint was written"
            )
    except Exception as exc:  # noqa: BLE001 — agreed below, then raised
        err = exc
    if nprocs > 1:
        word = np.array([0, -1] if err is not None else [1, turn], dtype=np.int64)
        agreed = allgather(word)  # (nprocs, 2)
        if err is not None:
            raise err
        failed = int(nprocs - agreed[:, 0].sum())
        if failed:
            raise ValueError(
                f"checkpoint load: shard validation failed on {failed} "
                f"other rank(s); the job cannot resume from {path}"
            )
        turns = agreed[:, 1]
        if int(turns.min()) != int(turns.max()):
            raise ValueError(
                f"checkpoint shards disagree on the turn "
                f"({int(turns.min())}..{int(turns.max())}): a crash "
                "between per-rank writes left a mixed set; restore from "
                "an older consistent checkpoint"
            )
    elif err is not None:
        raise err
    return ShardedBoard.from_process_local(mesh, rows, gshape), turn, rule, word_axis
