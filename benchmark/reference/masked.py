"""Frozen copy of stutter_tpu_torch/ops/masked.py (the port's plain version), for the benchmark's reference.

Masked reductions for variable-length clips padded into frame buckets
(counterpart of stutter_tpu/ops/masked.py).

Every statistic reduces over each clip's valid frames only, with NumPy's
semantics on the unpadded array.
"""

from __future__ import annotations

import torch


def frame_mask(lengths: torch.Tensor, hop_length: int, t_max: int) -> torch.Tensor:
    """[B, t_max] bool: frame t is valid iff t < 1 + length // hop (librosa)."""
    n_frames = 1 + torch.div(lengths, hop_length, rounding_mode="floor")
    return torch.arange(t_max, device=lengths.device)[None, :] < n_frames[:, None]


def _expand(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.unsqueeze(-1).expand_as(x) if mask.ndim < x.ndim else mask


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis: int) -> torch.Tensor:
    """Mean over `axis` of the masked positions only, count clamped >= 1."""
    mask = _expand(mask, x)
    cnt = mask.sum(dim=axis).clamp_min(1).to(x.dtype)
    return torch.where(mask, x, 0.0).sum(dim=axis) / cnt


def masked_mean_std(
    x: torch.Tensor, mask: torch.Tensor, axis: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-pass masked mean and population std (ddof 0), count clamped >= 1."""
    mean = masked_mean(x, mask, axis)
    centered = x - mean.unsqueeze(axis)
    return mean, torch.sqrt(masked_mean(centered * centered, mask, axis))


def masked_max(x: torch.Tensor, mask: torch.Tensor, axis, keepdims: bool = False) -> torch.Tensor:
    return torch.amax(torch.where(_expand(mask, x), x, -torch.inf), dim=axis, keepdim=keepdims)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Exact np.median(x[mask]) per row; x, mask: [B, N] -> [B].

    The two middle order statistics come from a sort with +inf fill, so the
    result is 0.5 * (lo + hi) in f32 exactly as the JAX radix select gives
    it (ops/masked.py:74); rows with no valid entry return 0."""
    cnt = mask.sum(dim=-1)
    s = torch.sort(torch.where(mask, x, torch.inf), dim=-1).values
    lo_idx = torch.div((cnt - 1).clamp_min(0), 2, rounding_mode="floor")
    hi_idx = torch.div(cnt.clamp_min(1), 2, rounding_mode="floor")
    lo = torch.gather(s, 1, lo_idx[:, None])[:, 0]
    hi = torch.gather(s, 1, hi_idx[:, None])[:, 0]
    return torch.where(cnt > 0, 0.5 * (lo + hi), 0.0)
