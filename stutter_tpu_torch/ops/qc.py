"""Audio-quality (QC) metrics for the per-file analysis report (counterpart of
stutter_tpu/ops/qc.py), plain PyTorch on the batch's device.

The reference's per-file metrics (pipeline1.py:151-186): segmental SNR, mean
spectral flatness and the high-frequency energy ratio, computed before and
after cleaning for per_file_analysis.csv (pipeline1.py:371-424).  As in the
JAX package, the hf ratio is taken over the rFFT of the zero-padded bucket,
which samples the clip's spectrum on a finer grid.
"""

from __future__ import annotations

import numpy as np
import torch

from stutter_tpu_torch.ops.masked import frame_mask, masked_mean
from stutter_tpu_torch.ops.spectral import power_spectrogram


def _masked_percentile_linear(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(x[mask], q) per row (linear interpolation), via sort."""
    cnt = mask.sum(dim=-1)
    s = torch.sort(torch.where(mask, x, torch.inf), dim=-1).values
    pos = (q / 100.0) * (cnt - 1).clamp_min(0).to(x.dtype)
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    vlo = torch.gather(s, 1, lo[:, None])[:, 0]
    vhi = torch.gather(s, 1, hi[:, None])[:, 0]
    return vlo + (pos - lo.to(x.dtype)) * (vhi - vlo)


def snr_db_batch(audio: torch.Tensor, lengths: torch.Tensor, sr: int = 16000) -> torch.Tensor:
    """Segmental energy SNR in dB (ref pipeline1.py:151-165): 25 ms frames at a
    10 ms hop without padding; noise = mean energy of the frames below the
    25th percentile; 10 log10(mean energy / (noise energy + 1e-10)).  0.0 for
    clips shorter than one frame or without a frame below the percentile."""
    frame_length, hop = int(0.025 * sr), int(0.010 * sr)
    n_frames = 1 + (audio.shape[1] - frame_length) // hop
    frames = audio.unfold(-1, frame_length, hop)[:, :n_frames]
    energy = (frames * frames).sum(dim=-1)  # [B, T]
    n_valid = 1 + torch.div(lengths.clamp_min(frame_length) - frame_length, hop,
                            rounding_mode="floor")
    valid = torch.arange(n_frames, device=audio.device)[None, :] < n_valid[:, None]
    p25 = _masked_percentile_linear(energy, valid, 25.0)
    noise_mask = valid & (energy < p25[:, None])
    n_noise = noise_mask.sum(dim=-1)
    noise_power = torch.where(noise_mask, energy, 0.0).sum(dim=-1) / n_noise.clamp_min(1)
    signal_power = masked_mean(energy[..., None], valid, axis=1)[:, 0]
    snr = 10.0 * torch.log10(signal_power / (noise_power + 1e-10))
    return torch.where((lengths >= frame_length) & (n_noise > 0), snr, 0.0)


def spectral_flatness_mean_batch(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    amin: float = 1e-10,
) -> torch.Tensor:
    """Mean spectral flatness over valid frames (ref pipeline1.py:168-174;
    librosa power=2)."""
    power = power_spectrogram(audio, n_fft, hop_length)
    mask = frame_mask(lengths, hop_length, power.shape[1])
    S = torch.clamp_min(power, amin)
    flat = torch.exp(torch.log(S).mean(dim=-1)) / S.mean(dim=-1)  # [B, T]
    return masked_mean(flat[..., None], mask, axis=1)[:, 0]


def high_freq_energy_ratio_batch(
    audio: torch.Tensor, lengths: torch.Tensor, sr: int = 16000, cutoff_hz: float = 4000.0
) -> torch.Tensor:
    """rFFT energy above cutoff_hz over the total (ref pipeline1.py:177-186)."""
    spec = torch.fft.rfft(audio, dim=-1)
    e = spec.real**2 + spec.imag**2
    high = torch.as_tensor(np.fft.rfftfreq(audio.shape[1], 1.0 / sr) > cutoff_hz,
                           device=audio.device)
    return torch.where(high, e, 0.0).sum(dim=-1) / (e.sum(dim=-1) + 1e-10)


def qc_metrics_batch(audio: torch.Tensor, lengths: torch.Tensor, sr: int = 16000) -> dict:
    """All three QC metrics -> dict of [B] tensors."""
    return {
        "snr_db": snr_db_batch(audio, lengths, sr),
        "spectral_flatness": spectral_flatness_mean_batch(audio, lengths, sr),
        "hf_energy_ratio": high_freq_energy_ratio_batch(audio, lengths, sr),
    }
