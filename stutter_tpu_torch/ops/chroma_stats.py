"""Chroma filterbank apply + per-frame inf-norm + masked statistics.

Replaces the TPU kernel `chroma_stats_pallas` (stutter_tpu/ops/pallas_chroma.py:95):
frame-masked power [B, T, K] + tuning bin [B] + valid frame count [B] ->
[B, 2 * n_chroma] (chroma means, then stds, over valid frames).  A CUDA
tensor launches csrc/chroma_stats.cu (a cluster of `cluster_size` blocks per
clip); a CPU tensor runs the plain version.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from stutter_tpu_torch import _build
from stutter_tpu_torch.ops.chroma import chroma_from_power
from stutter_tpu_torch.ops.consts import fb_table_rows
from stutter_tpu_torch.ops.masked import masked_mean_std


def chroma_stats_plain(
    power: torch.Tensor,
    tuning_bin: torch.Tensor,
    n_valid: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 2048,
    n_chroma: int = 12,
) -> torch.Tensor:
    ch = chroma_from_power(power, tuning_bin, sr, n_fft, n_chroma)
    mask = torch.arange(power.shape[1], device=power.device)[None, :] < n_valid[:, None]
    mean, std = masked_mean_std(ch, mask, axis=1)
    return torch.cat([mean, std], dim=-1)


BLOCKS = 256  # blocks a launch aims at: ~2 on each of an H100's 132 SMs


def cluster_size(B: int, T: int) -> int:
    """Blocks per clip: up to 8 (a portable cluster), BLOCKS over the batch
    (the best of 1, 2, 3, 4 and 8 on an H100 at B=256 x 3 s, B=64 x 10 s
    and one 3 s request, `PERF.md`), and no more than the clip's 4-frame
    groups."""
    return max(1, min(8, -(-BLOCKS // B), -(-T // 4)))


@lru_cache(maxsize=None)
def _device_table(device: str, sr: int, n_fft: int, n_chroma: int) -> torch.Tensor:
    """[100 * n_chroma, KP]: the filterbank rows, zero past K.  KP is K + 3
    rounded up to a multiple of 128, the bins a warp of the kernel covers a
    step (its last step reads up to 3 bins past K)."""
    rows = fb_table_rows(sr, n_fft, n_chroma)
    table = np.zeros((rows.shape[0], -(-(rows.shape[1] + 3) // 128) * 128), np.float32)
    table[:, : rows.shape[1]] = rows
    return torch.as_tensor(table, device=device)


def _chroma_stats_cuda(power, tuning_bin, n_valid, sr, n_fft, n_chroma):
    B, T, K = power.shape
    if n_chroma != 12 or K != n_fft // 2 + 1 or power.dtype != torch.float32:
        raise ValueError(f"chroma_stats kernel takes 12 chroma bins and float32 power "
                         f"[B, T, n_fft//2+1]; got n_chroma={n_chroma}, {tuple(power.shape)}")
    if tuning_bin.device != power.device or n_valid.device != power.device:
        raise ValueError("chroma_stats kernel takes tuning_bin and n_valid on power's device")
    power = power.contiguous()
    if power.data_ptr() % 16:  # the kernel reads aligned float4s
        power = power.clone()
    tb = tuning_bin.to(torch.int32).contiguous()
    nv = n_valid.to(torch.int32).contiguous()
    table = _device_table(str(power.device), sr, n_fft, n_chroma)
    out = torch.empty(B, 2 * n_chroma, device=power.device)
    fn = _build.bind("chroma_stats", "chroma_stats_launch", 5, 6)
    rc = _build.launch(fn, power, power.data_ptr(), tb.data_ptr(), nv.data_ptr(),
                       table.data_ptr(), out.data_ptr(), B, T, K, table.shape[1],
                       table.shape[0] // n_chroma, cluster_size(B, T))
    _build.check(rc, "chroma_stats_launch")
    chroma_stats.launches += 1
    return out


def chroma_stats(
    power: torch.Tensor,
    tuning_bin: torch.Tensor,
    n_valid: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 2048,
    n_chroma: int = 12,
) -> torch.Tensor:
    """== cat(masked_mean_std(chroma_from_power(power, tb), frames < n_valid)).
    A CUDA tensor launches the kernel; a CPU tensor runs the plain version."""
    if power.is_cuda:
        return _chroma_stats_cuda(power, tuning_bin, n_valid, sr, n_fft, n_chroma)
    if power.device.type == "cpu":
        return chroma_stats_plain(power, tuning_bin, n_valid, sr, n_fft, n_chroma)
    raise ValueError(f"chroma_stats: no kernel for device {power.device}")


chroma_stats.launches = 0  # kernel launches of this wrapper, read by chip_smoke.py
