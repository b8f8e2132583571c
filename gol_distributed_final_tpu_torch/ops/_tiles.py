"""What the two tiled kernels' wrappers share: ops/tiled.py (int32
bitboards, csrc/tiled.cu) and ops/byte_tiled.py (uint8 boards,
csrc/byte_tiled.cu). Both kernels run k turns per launch on a 2-D grid of
tiles, each block stepping its tile's window (the tile and a halo on all
four sides, indices taken modulo the board) and writing back the
interior. Only the turn, the halo and the C entry point differ, so each
wrapper hands those to the helpers here.
"""

from __future__ import annotations

import contextlib

import torch


def launch_sizes(n: int, turns_per_launch: int, max_turns: int, what: str) -> list[int]:
    """n turns as launches of ``turns_per_launch`` turns, the last taking
    the rest; a launch takes 1..``max_turns`` turns (the halo depth)."""
    if not 1 <= turns_per_launch <= max_turns:
        raise ValueError(f"{what} takes 1..{max_turns} turns per launch (the halo "
                         f"depth), got {turns_per_launch}")
    full, rem = divmod(int(n), turns_per_launch)
    return [turns_per_launch] * full + ([rem] if rem else [])


def launch_plain(board, k: int, tile: tuple[int, int], step_n, halo=None):
    """What one kernel launch computes, in torch: every tile's window (the
    tile and ``halo`` = (rows, cols) on each side, k and k unless given)
    gathered with modulo indices, ``step_n(windows, k)`` on the batch of
    windows (the cyclic rolls of a plain turn only spoil the ring the
    shrinking cone discards), and the interiors put back together."""
    rows, cols = board.shape
    tr, tc = tile
    hr, hc = (k, k) if halo is None else halo
    grid_r, grid_c = -(-rows // tr), -(-cols // tc)
    dev = board.device
    ri = (torch.arange(grid_r, device=dev)[:, None] * tr - hr
          + torch.arange(tr + 2 * hr, device=dev)[None, :]) % rows
    ci = (torch.arange(grid_c, device=dev)[:, None] * tc - hc
          + torch.arange(tc + 2 * hc, device=dev)[None, :]) % cols
    windows = step_n(board[ri[:, None, :, None], ci[None, :, None, :]], k)
    interior = windows[..., hr:hr + tr, hc:hc + tc]
    out = interior.permute(0, 2, 1, 3).reshape(grid_r * tr, grid_c * tc)
    return out[:rows, :cols].contiguous()


def on_device(board: torch.Tensor):
    """``(guard, stream)`` for launches on the board's CUDA device: the
    current stream's handle there, and a context that makes the device
    current, which is empty where it already is (the usual case: entering
    ``torch.cuda.device`` costs more host time than a short kernel runs)."""
    index = board.device.index
    if index is None or index == torch.cuda.current_device():
        return contextlib.nullcontext(), torch.cuda.current_stream().cuda_stream
    return torch.cuda.device(index), torch.cuda.current_stream(index).cuda_stream


def ping_pong(board: torch.Tensor, sizes, launch) -> torch.Tensor:
    """``launch(src, dst, k, stream)`` once for each k of ``sizes``, on the
    board's CUDA device and current stream, both taken once for all the
    launches. Blocks run in no order, so no launch may write the board it
    reads: two scratch boards, allocated once, alternate as the destination
    and ``board`` is never written. Returns the last board written
    (``board`` itself when ``sizes`` is empty)."""
    src, scratch = board, [torch.empty_like(board)]
    guard, stream = on_device(board)
    with guard:
        for i, k in enumerate(sizes):
            if i == 1:
                scratch.append(torch.empty_like(board))
            dst = scratch[i % 2]
            launch(src, dst, k, stream)
            src = dst
    return src
