"""Polyphase resampling with a Kaiser-windowed sinc (counterpart of
stutter_tpu/ops/resample.py).

A rational resampler: for output sample n with t = n*M + centre,
y[n] = sum_k h[t % L + k*L] * x[t // L - k], the Kaiser-sinc prototype
(beta 14.77, librosa 'kaiser_best') folded into L phases.  Plain PyTorch:
the JAX version is XLA, not a Pallas kernel.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _polyphase_filter(L: int, M: int, taps_per_phase: int = 24, beta: float = 14.769656459379492):
    """([L, n_taps // L] phase taps, n_taps) of the Kaiser-sinc low-pass; the
    prototype length scales with max(L, M), rounded up to a multiple of L."""
    n_taps = -(-taps_per_phase * max(L, M) // L) * L
    cutoff = 1.0 / max(L, M)
    k = np.arange(n_taps, dtype=np.float64) - (n_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * k) * np.kaiser(n_taps, beta)
    h *= L  # gain of the zero-stuffed upsampling
    return h.reshape(n_taps // L, L).T.astype(np.float32).copy(), n_taps


def _rational(sr_in: int, sr_out: int) -> tuple[int, int]:
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g  # L (up), M (down)


def resample_batch(
    audio: torch.Tensor, sr_in: int, sr_out: int, n_out: int, taps_per_phase: int = 24
) -> torch.Tensor:
    """audio [B, N] at sr_in -> [B, n_out] at sr_out."""
    L, M = _rational(sr_in, sr_out)
    if L == 1 and M == 1:
        return audio[:, :n_out]
    hphase, n_taps = _polyphase_filter(L, M, taps_per_phase)
    N = audio.shape[1]
    t = np.arange(n_out, dtype=np.int64) * M + (n_taps - 1) // 2
    idx = (t // L)[:, None] - np.arange(hphase.shape[1])[None, :]  # [n_out, taps]
    valid = (idx >= 0) & (idx < N)
    dev = audio.device
    gathered = audio[:, torch.as_tensor(np.where(valid, idx, 0), device=dev)]
    gathered = torch.where(torch.as_tensor(valid, device=dev), gathered, 0.0)
    taps = torch.as_tensor(hphase[t % L], device=dev)  # [n_out, taps]
    return (gathered * taps).sum(dim=-1)


RESAMPLE_BUCKET = 16384  # input lengths pad to this multiple


def resample(
    y: np.ndarray, sr_in: int, sr_out: int, device: torch.device | str = "cpu"
) -> np.ndarray:
    """1-D clip -> resampled 1-D clip.  The input is zero-padded to a
    RESAMPLE_BUCKET multiple, which leaves the samples unchanged (taps past
    the end read zeros either way) and keeps the set of shapes bounded."""
    n = len(y)
    n_out = int(math.ceil(n * sr_out / sr_in))
    n_pad = -(-max(n, 1) // RESAMPLE_BUCKET) * RESAMPLE_BUCKET
    buf = np.zeros(n_pad, np.float32)
    buf[:n] = y
    out = resample_batch(
        torch.from_numpy(buf)[None, :].to(device), sr_in, sr_out,
        int(math.ceil(n_pad * sr_out / sr_in)),
    )
    return out[0, :n_out].cpu().numpy()
