"""Batched 334-variant feature extraction, 286 dims computed (counterpart of
stutter_tpu/ops/frontend334.py).

Ref: main.py:718-763, with the intended semantics (the reference's own
extractor zeroes every vector, main.py:753): 40 MFCC + delta + delta-delta
(n_fft 512, hop 256) mean/std, chroma(12) mean/std, spectral contrast
(7 bands) mean/std, the zcr/rms/centroid scalars and 5 text dims.

The power, mel and tuning bin come from the spectromel kernel's mel-output
mode (`ops.frontend.spect_mel_db`; its plain version on a CPU tensor).
Everything after it is plain PyTorch, as the JAX package computes it in XLA
outside any Pallas kernel: chroma through `ops.chroma.chroma_from_power`
(not the chroma-stats kernel), contrast, zcr, rms and the centroid here,
each masked to the clip's own frames.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from stutter_tpu_torch.ops.chroma import chroma_from_power
from stutter_tpu_torch.ops.delta import sg_deltas
from stutter_tpu_torch.ops.frontend import _stat_pair, spect_mel_db
from stutter_tpu_torch.ops.masked import masked_mean
from stutter_tpu_torch.ops.spectral import frame, mfcc_from_db


@lru_cache(maxsize=None)
def _contrast_bands(sr: int, n_fft: int, fmin: float, n_bands: int) -> tuple:
    """librosa's [lo, hi) bin range of each band: octave edges from fmin, each
    band including the bin just below its lower edge (except band 0)."""
    freq = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    bands = []
    for k in range(n_bands + 1):
        idx = np.flatnonzero((freq >= octa[k]) & (freq <= octa[k + 1]))
        lo = idx[0] - 1 if k > 0 else idx[0]
        bands.append((int(lo), int(idx[-1]) + 1))
    return tuple(bands)


def spectral_contrast_batch(
    mag: torch.Tensor,
    sr: int,
    n_fft: int,
    fmin: float = 200.0,
    n_bands: int = 6,
    quantile: float = 0.02,
    amin: float = 1e-10,
) -> torch.Tensor:
    """Magnitude spectrogram [B, T, K] -> contrast [B, T, n_bands + 1] in dB
    (librosa linear=False): per band, the mean of the top and of the bottom
    `quantile` of its sorted bins."""
    outs = []
    for lo, hi in _contrast_bands(sr, n_fft, fmin, n_bands):
        n_quant = max(int(np.rint(quantile * (hi - lo))), 1)
        s = torch.sort(mag[..., lo:hi], dim=-1).values
        valley = s[..., :n_quant].mean(dim=-1)
        peak = s[..., -n_quant:].mean(dim=-1)
        outs.append(10.0 * torch.log10(torch.clamp_min(peak, amin))
                    - 10.0 * torch.log10(torch.clamp_min(valley, amin)))
    return torch.stack(outs, dim=-1)


def zcr_batch(audio: torch.Tensor, lengths: torch.Tensor, frame_length: int = 2048,
              hop: int = 256) -> torch.Tensor:
    """librosa zero_crossing_rate per frame [B, 1 + N // hop] (center=True,
    edge padding, zero-clip threshold 1e-10); frames past a clip's end are
    garbage and masked by the caller."""
    B, N = audio.shape
    pos = torch.arange(N, device=audio.device)[None, :]
    last = torch.gather(audio, 1, (lengths.long() - 1).clamp_min(0)[:, None])
    # each clip's last sample repeats through the batch padding (edge pad)
    edge = torch.where(pos < lengths[:, None], audio, last)
    half = frame_length // 2
    padded = torch.cat([edge[:, :1].expand(B, half), edge, edge[:, -1:].expand(B, half)], dim=1)
    frames = padded.unfold(-1, frame_length, hop)
    clipped = torch.where(frames.abs() <= 1e-10, 0.0, frames)
    sb = torch.signbit(clipped)
    crossings = sb[..., :-1] != sb[..., 1:]
    return crossings.float().mean(dim=-1)[:, : 1 + N // hop]


def rms_batch(audio: torch.Tensor, frame_length: int = 2048, hop: int = 256) -> torch.Tensor:
    """librosa.feature.rms [B, 1 + N // hop] (center=True, constant padding)."""
    frames = frame(audio, frame_length, hop)
    return torch.sqrt((frames * frames).mean(dim=-1))


def extract_features_334_batch(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 512,
    hop_length: int = 256,
    n_mels: int = 128,
    n_mfcc: int = 40,
    n_chroma: int = 12,
) -> torch.Tensor:
    """audio [B, N] (zero-padded, N a multiple of 512), lengths [B] -> [B, 286].

    Clips with fewer than 9 valid frames give all-zero vectors."""
    B = audio.shape[0]
    power, mask, db, tb = spect_mel_db(audio, lengths, sr, n_fft, hop_length, n_mels, n_chroma)
    n_valid = 1 + torch.div(lengths, hop_length, rounding_mode="floor")

    mf = mfcc_from_db(db, n_mfcc)
    d1, d2 = sg_deltas(mf, n_valid, orders=(1, 2))
    ch = chroma_from_power(power, tb, sr, n_fft, n_chroma)

    mag = torch.sqrt(power)
    contrast = spectral_contrast_batch(mag, sr, n_fft)
    zcr = zcr_batch(audio, lengths, 2048, hop_length)
    rms = rms_batch(audio, 2048, hop_length)
    freqs = torch.as_tensor(np.linspace(0, sr / 2.0, 1 + n_fft // 2, dtype=np.float32),
                            device=audio.device)
    cent = (freqs * mag).sum(dim=-1) / torch.clamp_min(mag.sum(dim=-1),
                                                       float(np.finfo(np.float32).tiny))

    def scalar_mean(x):
        return masked_mean(x[..., None], mask, axis=1)

    feats = torch.cat(
        [_stat_pair(mf, mask), _stat_pair(d1, mask), _stat_pair(d2, mask),
         _stat_pair(ch, mask), _stat_pair(contrast, mask),
         scalar_mean(zcr), scalar_mean(rms), scalar_mean(cent), audio.new_zeros(B, 5)],
        dim=-1,
    )
    return torch.where((n_valid >= 9)[:, None], feats, 0.0)
