"""Frozen copy of stutter_tpu_torch/ops/consts.py (the port's plain version), for the benchmark's reference.

Host-side constant tables of the plain path, built in float64 NumPy and
kept float32 (the kernels' launch geometry and tables are left out).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .config import DenoiseConfig
from . import filterbanks as fb

F32_TINY = float(np.finfo(np.float32).tiny)
TUNE_BINS = 100  # ceil(1 / resolution) at librosa's resolution 0.01
TUNE_THRESHOLD = 0.1  # librosa piptrack default
PIP_FMIN, PIP_FMAX = 150.0, 4000.0  # librosa estimate_tuning's piptrack band


@lru_cache(maxsize=None)
def mask_smoothing_profiles(cfg: DenoiseConfig) -> tuple[np.ndarray, np.ndarray] | None:
    """(freq_taps, time_taps) of the separable triangular mask smoother, or
    None when both widths are 1 (denoise.py:43)."""
    n_grad_freq = int(cfg.freq_mask_smooth_hz / (cfg.sample_rate / (cfg.n_fft / 2)))
    n_grad_time = int(cfg.time_mask_smooth_ms / ((cfg.hop_length / cfg.sample_rate) * 1000))
    if n_grad_freq == 1 and n_grad_time == 1:
        return None
    f_prof = np.concatenate(
        [np.linspace(0, 1, n_grad_freq + 1, endpoint=False), np.linspace(1, 0, n_grad_freq + 2)]
    )[1:-1]
    t_prof = np.concatenate(
        [np.linspace(0, 1, n_grad_time + 1, endpoint=False), np.linspace(1, 0, n_grad_time + 2)]
    )[1:-1]
    total = np.outer(f_prof, t_prof).sum()
    # normalise the separable pair so the 2-D kernel sums to 1
    return (f_prof / f_prof.sum()).astype(np.float32), (
        t_prof * f_prof.sum() / total
    ).astype(np.float32)


def iir_coefficient(cfg: DenoiseConfig) -> float:
    """b of noisereduce's filtfilt([b], [1, b-1]) for cfg.time_constant_s
    (denoise.py:193)."""
    t_frames = cfg.time_constant_s * cfg.sample_rate / float(cfg.hop_length)
    return float((np.sqrt(1 + 4 * t_frames**2) - 1) / (2 * t_frames**2))


@lru_cache(maxsize=None)
def window_sumsquare(t_frames: int, n_fft: int, hop: int) -> np.ndarray:
    """librosa iSTFT normalisation: the sum of squared Hann windows per
    output sample, [(t_frames - 1) * hop + n_fft] (denoise.py:110)."""
    w2 = np.asarray(fb.hann(n_fft), np.float64) ** 2
    out = np.zeros((t_frames - 1) * hop + n_fft)
    for t in range(t_frames):
        out[t * hop : t * hop + n_fft] += w2
    return out.astype(np.float32)


@lru_cache(maxsize=None)
def band_range(sr: int, n_fft: int, fmin: float, fmax: float) -> tuple[int, int]:
    """[lo, hi) FFT-bin range with fmin <= f < fmax (ops/chroma.py:44)."""
    freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mask = (max(fmin, 0.0) <= freqs) & (freqs < min(fmax, sr / 2.0))
    idx = np.flatnonzero(mask)
    return int(idx[0]), int(idx[-1]) + 1


@lru_cache(maxsize=None)
def residual_table(sr: int, n_fft: int, n_freqs: int, n_chroma: int) -> np.ndarray:
    """[n_freqs]: mod(n_chroma * log2(bin * sr / (n_fft * 27.5)), 1) in f64,
    0 at DC (ops/chroma.py:53).  The pitch residual of a candidate is this
    plus a series in shift/bin, never a device log2."""
    bins = np.arange(n_freqs, dtype=np.float64)
    bins[0] = 1.0
    r = np.mod(n_chroma * np.log2(bins * sr / (n_fft * (440.0 / 16.0))), 1.0)
    r[0] = 0.0
    return r.astype(np.float32)


@lru_cache(maxsize=None)
def savgol_taps(width: int = 9) -> np.ndarray:
    """[2, 1 + 2 * half, width] f32: per delta order 1 and 2, the interior
    taps, then the `half` first-edge rows, then the `half` last-edge rows of
    scipy's savgol_filter(mode='interp').  This is the unsplit f32 form of
    the banded [T, T] operators of pallas_spectromel.py:270: row t >= half of
    the band is the interior taps centred on t, rows < half are the first
    edge, and the last-edge rows sit at each clip's n_valid - half ..."""
    rows = []
    for order in (1, 2):
        ops = fb.savgol_ops(width, order)
        rows.append(np.concatenate([ops.interior[None, :], ops.first, ops.last]))
    return np.ascontiguousarray(np.stack(rows).astype(np.float32))


