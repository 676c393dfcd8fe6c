"""Frozen copy of stutter_tpu_torch/ops/delta.py (the port's plain version), for the benchmark's reference.

Batched Savitzky-Golay deltas with mode='interp' edges (counterpart of
stutter_tpu/ops/delta.py).

librosa.feature.delta is scipy.signal.savgol_filter(width=9, polyorder=o,
deriv=o, mode='interp'): a 9-tap correlation in the interior plus polynomial
edge rows fitted to the first and the last 9 valid frames.  With frame
buckets, the last 9 valid frames start at each clip's own n_valid - 9.
Clips with fewer than `width` valid frames are zeroed by the caller.
"""

from __future__ import annotations

import torch

from .consts import savgol_taps


def sg_deltas(
    x: torch.Tensor, n_valid: torch.Tensor, orders: tuple = (1, 2), width: int = 9
) -> tuple:
    """x: [B, T, C] features, n_valid: [B] -> one [B, T, C] delta per order.

    Output rows >= n_valid are garbage and must be masked by the caller."""
    half = width // 2
    B, T, C = x.shape
    taps = torch.as_tensor(savgol_taps(width), device=x.device)
    xp = torch.nn.functional.pad(x, (0, 0, half, half))
    t_idx = torch.arange(T, device=x.device)[None, :]
    # the last `width` valid frames of each clip, and where their edge rows go
    start = (n_valid - width).clamp_min(0)
    win_idx = start[:, None] + torch.arange(width, device=x.device)[None, :]  # [B, width]
    win = torch.gather(x, 1, win_idx[:, :, None].expand(B, width, C))
    offset = t_idx - (n_valid[:, None] - half)  # 0..half-1 at the edge rows
    is_edge = (offset >= 0) & (offset < half)

    outs = []
    for order in orders:
        k = taps[order - 1]
        interior, first, last = k[0], k[1 : 1 + half], k[1 + half :]
        y = sum(interior[j] * xp[:, j : j + T] for j in range(width))
        y[:, :half] = torch.einsum("ew,bwc->bec", first, x[:, :width])
        edge = torch.einsum("ew,bwc->bec", last, win)  # [B, half, C]
        edge_rows = torch.gather(edge, 1, offset.clamp(0, half - 1)[:, :, None].expand(B, T, C))
        outs.append(torch.where(is_edge[:, :, None], edge_rows, y))
    return tuple(outs)


def sg_delta(x: torch.Tensor, n_valid: torch.Tensor, order: int = 1, width: int = 9) -> torch.Tensor:
    """Single-order convenience wrapper over sg_deltas."""
    return sg_deltas(x, n_valid, (order,), width)[0]
