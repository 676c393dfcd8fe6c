"""Host-side constant tables of the port, built in float64 NumPy, kept float32.

The JAX package builds these inside modules that import JAX (ops/spectral,
denoise, ops/chroma, ops/pallas_*), and splits several into bf16 hi/lo pairs
for the TPU's matrix unit.  The port needs the same tables without JAX and
uses them whole in FP32, so they are rebuilt here from the same formulas;
tests/test_torch_consts.py holds each against its JAX original.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from stutter_tpu.config import DenoiseConfig
from stutter_tpu.ops import filterbanks as fb

F32_TINY = float(np.finfo(np.float32).tiny)
TUNE_BINS = 100  # ceil(1 / resolution) at librosa's resolution 0.01
TUNE_THRESHOLD = 0.1  # librosa piptrack default
PIP_FMIN, PIP_FMAX = 150.0, 4000.0  # librosa estimate_tuning's piptrack band


@lru_cache(maxsize=None)
def chunk_dft_mats(n_fft: int, hop: int) -> tuple[np.ndarray, np.ndarray]:
    """Unwindowed real-DFT cos/sin matrices of hop-length chunks, [hop, K]:
    Z_j[k] = sum_q chunk_j[q] e^{-2 pi i q k / n_fft} (ops/spectral.py:72)."""
    n = np.arange(hop, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@lru_cache(maxsize=None)
def chunk_phase_tables(n_fft: int, hop: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-slot phase factors e^{-2 pi i c hop k / n_fft}, [ratio, K]
    (ops/spectral.py:84); exact 0/+-1 for ratio 2 or 4."""
    ratio = n_fft // hop
    c = np.arange(ratio, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * c * hop * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


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
def ola_winv(t_frames: int, n_fft: int, hop: int) -> np.ndarray:
    """Reciprocal window-sum-square in the [T + ratio - 1, hop] overlap-add
    layout; samples whose sum is below f32 tiny divide by 1
    (pallas_denoise.py:103)."""
    wss = window_sumsquare(t_frames, n_fft, hop).astype(np.float64)
    denom = np.where(wss > F32_TINY, wss, 1.0)
    return (1.0 / denom).reshape(-1, hop).astype(np.float32)


@lru_cache(maxsize=None)
def idft_mats(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """[K, n_fft] real-IDFT matrices with the synthesis Hann and 1/N folded
    in: irfft(re + i im) * hann == re @ Cr + im @ Ci (pallas_denoise.py:64)."""
    K = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(K, dtype=np.float64)[:, None]
    w = np.full((K, 1), 2.0)
    w[0] = w[-1] = 1.0
    hann = np.asarray(fb.hann(n_fft), np.float64)[None, :]
    ang = 2.0 * np.pi * k * n[None, :] / n_fft
    cr = (w * np.cos(ang) / n_fft) * hann
    ci = (-w * np.sin(ang) / n_fft) * hann
    return cr.astype(np.float32), ci.astype(np.float32)


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
def fb_table_rows(sr: int, n_fft: int, n_chroma: int) -> np.ndarray:
    """[100 * n_chroma, K]: the 100 tuning-shifted chroma filterbanks as rows;
    clip b uses rows tb[b] * n_chroma ... + n_chroma - 1 (pallas_chroma.py:52)."""
    t = fb.chroma_fb_table(sr, n_fft, n_chroma)
    return np.ascontiguousarray(t.reshape(-1, t.shape[-1]))


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
