"""Frozen copy of stutter_tpu_torch/ops/spectral.py (the port's plain version), for the benchmark's reference.

Batched STFT power / mel / MFCC (counterpart of stutter_tpu/ops/spectral.py).

librosa semantics: stft(center=True, constant padding, periodic Hann),
Slaney mel, power_to_db(ref=1, amin=1e-10, top_db=80) with the clamp taken
per clip over its valid frames, orthonormal DCT-II.  These are the plain
PyTorch versions; on the card the fused spectromel kernel computes the same
chain (ops/spectromel.py).
"""

from __future__ import annotations

import torch

from . import filterbanks as fb
from .masked import masked_max


def frame(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """[B, N] zero-padded audio -> [B, T, n_fft] centred frames, T = 1 + N//hop.

    Needs hop | n_fft and hop | N; the centre padding is zeros (librosa
    pad_mode='constant'), which composes exactly with the batch padding."""
    B, N = audio.shape
    if N % hop_length or n_fft % hop_length:
        raise ValueError(f"N={N} and n_fft={n_fft} must be multiples of hop={hop_length}")
    padded = torch.nn.functional.pad(audio, (n_fft // 2, n_fft // 2))
    return padded.unfold(-1, n_fft, hop_length)


def hann(n: int, device) -> torch.Tensor:
    return torch.as_tensor(fb.hann(n), dtype=torch.float32, device=device)


def power_spectrogram(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """[B, N] -> [B, T, n_fft//2+1] |STFT|^2 with the periodic Hann window."""
    frames = frame(audio, n_fft, hop_length) * hann(n_fft, audio.device)
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real**2 + spec.imag**2


def db_from_mel(
    mel: torch.Tensor, mask: torch.Tensor, amin: float = 1e-10, top_db: float = 80.0
) -> torch.Tensor:
    """Linear mel [B, T, M] -> dB, clamped at (max over the clip's VALID
    frames) - top_db, so padding cannot move the clamp."""
    db = 10.0 * torch.log10(torch.clamp_min(mel, amin))
    clip_max = masked_max(db, mask, axis=(1, 2), keepdims=True)
    return torch.maximum(db, clip_max - top_db)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, device) -> torch.Tensor:
    """[n_mels, K] Slaney mel filterbank."""
    return torch.as_tensor(fb.mel_fb(sr, n_fft, n_mels), device=device)


def mel_power_to_db(
    power: torch.Tensor,
    mask: torch.Tensor,
    sr: int,
    n_fft: int,
    n_mels: int,
    amin: float = 1e-10,
    top_db: float = 80.0,
) -> torch.Tensor:
    """Power spec [B, T, K] -> log-mel [B, T, n_mels] (Slaney mel), per-clip
    top_db clamp."""
    mel_fb = mel_filterbank(sr, n_fft, n_mels, power.device)
    return db_from_mel(torch.matmul(power, mel_fb.T), mask, amin, top_db)


def mfcc_from_db(db: torch.Tensor, n_mfcc: int) -> torch.Tensor:
    """Log-mel [B, T, n_mels] -> MFCC [B, T, n_mfcc] (orthonormal DCT-II)."""
    dct = torch.as_tensor(fb.dct_mat(n_mfcc, db.shape[-1]), device=db.device)
    return torch.matmul(db, dct.T)
