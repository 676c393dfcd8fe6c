"""The signal path in plain PyTorch: frozen copies of the port's plain
versions of the resampler (ops/resample.py), the spectral gate
(ops/spectral_gate.py: spectral_gate_plain; denoise.py: denoise_batch),
spectromel's two modes and chroma_stats (ops/spectromel.py,
ops/chroma_stats.py: the *_plain functions), the 149-dim layout
(ops/frontend.py) and the sequence heads' frames (train/seq_trainer.py).

One clip at a time at its own sample bucket, as the port pads it: the gate
is not bucket-invariant (its backward smoothing runs in from the end of
the padded buffer), every frame statistic is.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .chroma import chroma_from_power, estimate_tuning_bin
from .config import DenoiseConfig
from .consts import (
    F32_TINY,
    iir_coefficient,
    mask_smoothing_profiles,
    window_sumsquare,
)
from .delta import sg_deltas
from .masked import frame_mask, masked_mean_std
from .spectral import db_from_mel, hann, mel_filterbank, mel_power_to_db, mfcc_from_db, \
    power_spectrogram

# sample-count buckets (multiples of hop 512) covering 0.45-10.1 s at 16 kHz
BUCKETS = (24576, 49152, 98304, 163840)
PAD = 30000  # noisereduce's chunk padding (samples)
T_MAX = 316  # the frame axis the sequence heads run at


def pad_to_bucket(n: int, buckets=BUCKETS) -> int:
    """Smallest bucket >= n; clips beyond the largest are cut to it."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def padded(y: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A clip zero-padded (or cut) to its bucket -> (audio [1, N], length [1])."""
    n = pad_to_bucket(len(y))
    buf = np.zeros((1, n), np.float32)
    m = min(len(y), n)
    buf[0, :m] = y[:m]
    return torch.from_numpy(buf).to(device), torch.tensor([m], dtype=torch.int32, device=device)


# ----------------------------------------------------------------- resampler

@lru_cache(maxsize=None)
def _polyphase_filter(L: int, M: int, taps_per_phase: int = 24, beta: float = 14.769656459379492):
    n_taps = -(-taps_per_phase * max(L, M) // L) * L
    cutoff = 1.0 / max(L, M)
    k = np.arange(n_taps, dtype=np.float64) - (n_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * k) * np.kaiser(n_taps, beta)
    h *= L
    return h.reshape(n_taps // L, L).T.astype(np.float32).copy(), n_taps


def resample(y: np.ndarray, sr_in: int, sr_out: int, device) -> np.ndarray:
    """1-D clip -> the Kaiser-sinc polyphase resampling at sr_out (taps past
    the end read zeros)."""
    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    n_out = int(math.ceil(len(y) * sr_out / sr_in))
    if L == 1 and M == 1:
        return np.asarray(y, np.float32)
    hphase, n_taps = _polyphase_filter(L, M)
    N = len(y)
    t = np.arange(n_out, dtype=np.int64) * M + (n_taps - 1) // 2
    idx = (t // L)[:, None] - np.arange(hphase.shape[1])[None, :]
    valid = (idx >= 0) & (idx < N)
    audio = torch.as_tensor(np.asarray(y, np.float32), device=device)
    gathered = audio[torch.as_tensor(np.where(valid, idx, 0), device=device)]
    gathered = torch.where(torch.as_tensor(valid, device=device), gathered, 0.0)
    taps = torch.as_tensor(hphase[t % L], device=device)
    return (gathered * taps).sum(dim=-1).cpu().numpy()


# ---------------------------------------------------------------------- gate

def _affine_scan(a: torch.Tensor, u: torch.Tensor, reverse: bool) -> torch.Tensor:
    B, T, K = a.shape
    s = 1
    while s < T:
        ones = a.new_ones(B, s, K)
        zeros = a.new_zeros(B, s, K)
        if reverse:
            a_sh = torch.cat([a[:, s:], ones], dim=1)
            u_sh = torch.cat([u[:, s:], zeros], dim=1)
        else:
            a_sh = torch.cat([ones, a[:, :-s]], dim=1)
            u_sh = torch.cat([zeros, u[:, :-s]], dim=1)
        u = a * u_sh + u
        a = a * a_sh
        s *= 2
    return u


def iir_smooth_bidirectional(x: torch.Tensor, b: float) -> torch.Tensor:
    T = x.shape[1]
    rows = torch.arange(T, device=x.device)[None, :, None]
    a0 = torch.where(rows == 0, 0.0, 1.0 - b).expand_as(x)
    fwd = _affine_scan(a0, torch.where(rows == 0, x, b * x), reverse=False)
    a1 = torch.where(rows == T - 1, 0.0, 1.0 - b).expand_as(x)
    return _affine_scan(a1, torch.where(rows == T - 1, fwd, b * fwd), reverse=True)


def smooth_mask(mask: torch.Tensor, cfg: DenoiseConfig) -> torch.Tensor:
    profiles = mask_smoothing_profiles(cfg)
    if profiles is None:
        return mask
    f_taps, t_taps = profiles
    B, T, K = mask.shape
    kf, kt = len(f_taps), len(t_taps)
    xp = torch.nn.functional.pad(mask, (kf // 2, kf - 1 - kf // 2))
    mask = sum(float(f_taps[i]) * xp[:, :, i : i + K] for i in range(kf))
    xp = torch.nn.functional.pad(mask, (0, 0, kt // 2, kt - 1 - kt // 2))
    return sum(float(t_taps[i]) * xp[:, i : i + T, :] for i in range(kt))


def spectral_gate(chunks: torch.Tensor, n_fft: int, hop: int, cfg: DenoiseConfig) -> torch.Tensor:
    """noisereduce's non-stationary gate on hop chunks [B, C, hop]: rfft
    STFT -> bidirectional IIR of |Y| -> sigmoid mask -> triangular mask
    smoothing -> prop_decrease blend -> irfft overlap-add over the window
    sum of squares."""
    B, C, _ = chunks.shape
    ratio = n_fft // hop
    T = C - ratio + 1
    win = hann(n_fft, chunks.device)
    frames = chunks.reshape(B, C * hop).unfold(-1, n_fft, hop)
    spec = torch.fft.rfft(frames * win, dim=-1)
    mag = torch.abs(spec)
    smooth = iir_smooth_bidirectional(mag, iir_coefficient(cfg))
    above = torch.where(smooth > 0, (mag - smooth) / torch.where(smooth > 0, smooth, 1.0), 0.0)
    mask = torch.sigmoid((above - cfg.thresh_n_mult_nonstationary)
                         * cfg.sigmoid_slope_nonstationary)
    mask = smooth_mask(mask, cfg)
    mask = mask * cfg.prop_decrease + (1.0 - cfg.prop_decrease)
    frames_t = torch.fft.irfft(spec * mask, n=n_fft, dim=-1) * win
    out = frames_t.new_zeros(B, (T + ratio - 1) * hop)
    for s in range(ratio):
        out[:, s * hop : s * hop + T * hop] += frames_t[:, :, s * hop : (s + 1) * hop].reshape(B, -1)
    wss = window_sumsquare(T, n_fft, hop)
    denom = torch.as_tensor(np.where(wss > F32_TINY, wss, 1.0), device=chunks.device)
    return (out / denom).reshape(B, T + ratio - 1, hop)


def denoise(audio: torch.Tensor, lengths: torch.Tensor, cfg: DenoiseConfig) -> torch.Tensor:
    """audio [B, N] zero-padded, lengths [B] -> gated and peak-normalised
    [B, N] (noisereduce's padding, librosa.util.normalize over the valid
    samples)."""
    B, N = audio.shape
    hop, n_fft = cfg.hop_length, cfg.n_fft
    buf_len = -(-(N + 2 * PAD) // hop) * hop
    x = torch.nn.functional.pad(audio, (PAD + n_fft // 2, buf_len - N - PAD + n_fft // 2))
    y = spectral_gate(x.reshape(B, -1, hop), n_fft, hop, cfg).reshape(B, -1)
    y = y[:, n_fft // 2 + PAD : n_fft // 2 + PAD + N]
    sample_mask = torch.arange(N, device=audio.device)[None, :] < lengths[:, None]
    y = torch.where(sample_mask, y, 0.0)
    peak = torch.amax(torch.abs(y), dim=1, keepdim=True)
    peak = torch.where(peak > F32_TINY, peak, 1.0)
    return y / peak


def denoise_clip(y: np.ndarray, cfg: DenoiseConfig, device) -> np.ndarray:
    """One clip gated at its own bucket -> its valid samples."""
    audio, length = padded(y, device)
    return denoise(audio, length, cfg)[0, : int(length[0])].cpu().numpy()


# ----------------------------------------------------------------- features

def features_149(audio: torch.Tensor, lengths: torch.Tensor, fe: dict) -> torch.Tensor:
    """audio [B, N] zero-padded, lengths [B] -> [B, 149]: MFCC, delta and
    delta2 means and stds, chroma means and stds, five zero text features;
    all zeros for a clip with fewer than 9 valid frames."""
    sr, n_fft, hop = fe["sample_rate"], fe["n_fft"], fe["hop_length"]
    n_mels, n_mfcc, n_chroma = fe["n_mels"], fe["n_mfcc"], fe["n_chroma"]
    B = audio.shape[0]
    power = power_spectrogram(audio, n_fft, hop)
    mask = frame_mask(lengths, hop, power.shape[1])
    power = torch.where(mask[:, :, None], power, 0.0)
    mf = mfcc_from_db(mel_power_to_db(power, mask, sr, n_fft, n_mels), n_mfcc)
    n_valid = 1 + torch.div(lengths, hop, rounding_mode="floor")
    d1, d2 = sg_deltas(mf, n_valid, orders=(1, 2))
    rows = []
    for x in (mf, d1, d2):
        rows.extend(masked_mean_std(x, mask, axis=1))
    stats = torch.stack(rows, dim=1)  # [B, 6, n_mfcc]
    tb = estimate_tuning_bin(power, sr, n_fft, n_chroma)
    ch = chroma_from_power(power, tb, sr, n_fft, n_chroma)
    cmask = torch.arange(power.shape[1], device=power.device)[None, :] < n_valid[:, None]
    cmean, cstd = masked_mean_std(ch, cmask, axis=1)
    feats = torch.cat([stats.reshape(B, 6 * n_mfcc), cmean, cstd, audio.new_zeros(B, 5)], dim=-1)
    return torch.where((n_valid >= 9)[:, None], feats, 0.0)


def features_149_clip(y: np.ndarray, fe: dict, device) -> np.ndarray:
    audio, length = padded(y, device)
    return features_149(audio, length, fe)[0].cpu().numpy()


def seq_frames(audio: torch.Tensor, lengths: torch.Tensor, kinds, sr: int = 16000,
               t_max: int = T_MAX) -> tuple[dict, torch.Tensor]:
    """[B, N] zero-padded audio -> ({kind: frames [B, t_max, D]}, valid
    frames [B], at most t_max): the log-mel (2048-point STFT, hop 512, 128
    mels, dB clamped 80 below the clip's valid maximum) and the 20 MFCC
    with their SavGol delta and delta2, cut or zero-padded to t_max."""
    power = power_spectrogram(audio, 2048, 512)
    mask = frame_mask(lengths, 512, power.shape[1])
    power = torch.where(mask[:, :, None], power, 0.0)
    mel = torch.matmul(power, mel_filterbank(sr, 2048, 128, power.device).T)
    db = db_from_mel(mel, mask)
    n_valid = 1 + torch.div(lengths, 512, rounding_mode="floor")
    out = {}
    if "logmel" in kinds:
        out["logmel"] = db
    if "mfcc_deltas" in kinds:
        mf = mfcc_from_db(db, 20)
        d1, d2 = sg_deltas(mf, n_valid, orders=(1, 2))
        out["mfcc_deltas"] = torch.cat([mf, d1, d2], dim=-1)
    T = power.shape[1]
    fit = {k: (f[:, :t_max] if T >= t_max else torch.nn.functional.pad(f, (0, 0, 0, t_max - T)))
           for k, f in out.items()}
    return fit, torch.clamp(n_valid, max=t_max)
