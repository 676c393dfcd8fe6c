"""Frozen copy of stutter_tpu_torch/ops/chroma.py (the port's plain version), for the benchmark's reference.

chroma_stft with librosa's signal-dependent tuning estimate (counterpart of
stutter_tpu/ops/chroma.py), plain PyTorch.

librosa.feature.chroma_stft estimates the tuning with piptrack (parabolic
peak interpolation on the power spectrogram), keeps candidates at or above
the median magnitude, takes the first maximum of a 100-bin histogram of
pitch residuals, and builds the chroma filterbank for that tuning.  The
tuning is always a histogram bin edge, so the 100 filterbanks come from a
host table indexed by bin.

The histogram flips on one-ulp differences, so every step here is one f32
operation in a fixed order, and the CUDA spectromel kernel repeats exactly
these operations (csrc/spectromel.cu: `candidate_at` for the candidates,
compacted per frame as `compact_candidates` lays them out, and
`tuning_tail` for the median and histogram, as `tuning_bin_from_compacted`
reads them).  The pitch residual
is an f64 host table at the bin plus an 8-term series in shift/bin, never a
device log2.
"""

from __future__ import annotations

import math

import torch

from . import filterbanks as fb
from .consts import (
    F32_TINY,
    PIP_FMAX,
    PIP_FMIN,
    TUNE_BINS,
    TUNE_THRESHOLD,
    band_range,
    residual_table,
)
from .masked import masked_median


def piptrack_candidates(
    power: torch.Tensor, sr: int, n_fft: int, n_chroma: int = 12
) -> tuple[torch.Tensor, torch.Tensor]:
    """power [B, T, K] (zero at invalid frames) -> (mags, idxm), each
    [B, T, band] over the bins [lo, hi) of piptrack's 150-4000 Hz band.

    mags: interpolated magnitude at candidates, 0 elsewhere; idxm: the
    candidate's residual histogram bin 0..99 as f32, -1 where there is no
    candidate.  The spectromel kernel emits these compacted per frame
    (`compact_candidates`).
    """
    lo, hi = band_range(sr, n_fft, PIP_FMIN, PIP_FMAX)
    S = power
    ref = TUNE_THRESHOLD * torch.amax(S, dim=-1, keepdim=True)
    Sb, hm, hp = S[..., lo:hi], S[..., lo - 1 : hi - 1], S[..., lo + 1 : hi + 1]

    avg = 0.5 * (hp - hm)
    den = 2.0 * Sb - hp - hm
    shift = avg / (den + (torch.abs(den) < F32_TINY).to(den.dtype))
    dskew = 0.5 * avg * shift
    g = Sb * (Sb > ref)
    cand = (g > hm * (hm > ref)) & (g >= hp * (hp > ref))
    binf = torch.arange(lo, hi, device=S.device, dtype=torch.float32)
    cand = cand & (binf + shift > 0)  # librosa keeps pitch > 0 only

    rb = torch.as_tensor(residual_table(sr, n_fft, S.shape[-1], n_chroma)[lo:hi], device=S.device)
    u = shift / torch.clamp_min(binf, 1.0)
    # log2(1+u) = (u - u^2/2 + u^3/3 - ...) / ln 2; |u| stays below ~0.03
    poly = u * (1.0 + u * (-1.0 / 2 + u * (1.0 / 3 + u * (-1.0 / 4 + u * (
        1.0 / 5 + u * (-1.0 / 6 + u * (1.0 / 7 + u * (-1.0 / 8))))))))
    residual = torch.fmod(rb + (n_chroma / math.log(2.0)) * poly, 1.0)
    residual = torch.where(residual < 0, residual + 1.0, residual)
    residual = torch.where(residual >= 0.5, residual - 1.0, residual)
    idx = torch.clamp(torch.floor((residual + 0.5) * TUNE_BINS), 0, TUNE_BINS - 1)
    return torch.where(cand, Sb + dskew, 0.0), torch.where(cand, idx, -1.0)


def tuning_bin_from_candidates(
    mags: torch.Tensor, idxm: torch.Tensor, n_bins: int = TUNE_BINS
) -> torch.Tensor:
    """Candidate arrays [B, T, W] -> [B] int32 tuning bin (the JAX package's
    ops/chroma.py:213).

    Exact median of the candidate magnitudes, then the first maximum of the
    histogram of candidates at or above it; bin n_bins // 2 (tuning 0.0)
    when a clip has no candidate.  Only `idxm >= 0` marks a candidate, so
    the slot layout of W does not matter."""
    B = mags.shape[0]
    mags, idxm = mags.reshape(B, -1), idxm.reshape(B, -1)
    cand = idxm >= 0
    med = masked_median(mags, cand)
    sel = cand & (mags >= med[:, None])
    idx = torch.where(sel, torch.round(idxm).long(), 0)
    hist = torch.zeros(B, n_bins, dtype=torch.int64, device=mags.device)
    hist.scatter_add_(1, idx, sel.long())
    first_max = torch.argmax(hist, dim=-1)
    return torch.where(sel.any(dim=-1), first_max, n_bins // 2).to(torch.int32)


def estimate_tuning_bin(
    power: torch.Tensor, sr: int, n_fft: int, n_chroma: int = 12
) -> torch.Tensor:
    """[B, T, K] power (invalid frames zeroed) -> [B] int32 tuning bin; bin i
    is tuning -0.5 + i * 0.01, librosa.estimate_tuning's value."""
    return tuning_bin_from_candidates(*piptrack_candidates(power, sr, n_fft, n_chroma))


def chroma_from_power(
    power: torch.Tensor, tuning_bin: torch.Tensor, sr: int, n_fft: int, n_chroma: int = 12
) -> torch.Tensor:
    """[B, T, K] power + [B] tuning bin -> [B, T, n_chroma], inf-normed per
    frame (a frame whose max is below f32 tiny divides by 1)."""
    table = torch.as_tensor(fb.chroma_fb_table(sr, n_fft, n_chroma), device=power.device)
    fbk = table[tuning_bin.long()]  # [B, C, K]
    raw = torch.matmul(power, fbk.transpose(1, 2))
    denom = torch.amax(torch.abs(raw), dim=-1, keepdim=True)
    denom = torch.where(denom < F32_TINY, 1.0, denom)
    return raw / denom
