"""Batched feature extraction (counterpart of stutter_tpu/ops/frontend.py).

The reference's canonical 149-dim feature contract (pipeline1.py:206-265):

  [mfcc mean(20) | mfcc std(20) | delta mean/std(40) | delta2 mean/std(40) |
   chroma mean(12) | chroma std(12) | text(5)]

Clips are padded into sample-count buckets (multiples of the hop); every
statistic is masked to each clip's own frame count, so a batch gives what
each clip gives alone.  Two fused ops carry it, each a CUDA kernel for CUDA
tensors and a plain PyTorch version for CPU tensors: `spectromel` (power,
MFCC/delta statistics, tuning bin) and `chroma_stats`.  The 286-dim variant
(ops/frontend334.py) goes through `spect_mel_db`, the spectromel kernel's
mel-output mode.
"""

from __future__ import annotations

import numpy as np
import torch

from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.ops.chroma_stats import chroma_stats
from stutter_tpu_torch.ops.masked import frame_mask, masked_mean_std
from stutter_tpu_torch.ops.spectral import db_from_mel
from stutter_tpu_torch.ops.spectromel import spectromel

# Sample-count buckets (multiples of hop=512) covering 0.45-10.1 s at 16 kHz.
DEFAULT_BUCKETS = (24576, 49152, 98304, 163840)


def spect_mel_db(audio, lengths, sr, n_fft, hop_length, n_mels, n_chroma=12):
    """(masked power [B, T, K], mask [B, T], log-mel dB [B, T, M], tuning bin
    [B]) for the batch, from the spectromel kernel's mel-output mode (a CUDA
    tensor) or its plain version (a CPU tensor)."""
    power, mel, tb = spectromel(audio, lengths, sr=sr, n_fft=n_fft, hop_length=hop_length,
                                n_mels=n_mels, n_chroma=n_chroma, with_stats=False)
    mask = frame_mask(lengths, hop_length, power.shape[1])
    return power, mask, db_from_mel(mel, mask), tb


def _stat_pair(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, T, C] + [B, T] -> [B, 2C] (means then stds, ref pipeline1.py:220-221)."""
    return torch.cat(masked_mean_std(x, mask, axis=1), dim=-1)


def extract_features_149_batch(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    n_mfcc: int = 20,
    n_chroma: int = 12,
) -> torch.Tensor:
    """audio [B, N] (zero-padded, N a multiple of hop), lengths [B] -> [B, 149].

    The text features are zeros (the reference's transcripts are empty).
    Clips with fewer than 9 valid frames (< 0.26 s) give all-zero vectors,
    as the reference's exception path does (pipeline1.py:237-239)."""
    B = audio.shape[0]
    n_valid = 1 + torch.div(lengths, hop_length, rounding_mode="floor")
    power, stats, tb = spectromel(
        audio, lengths, sr=sr, n_fft=n_fft, hop_length=hop_length,
        n_mels=n_mels, n_mfcc=n_mfcc, n_chroma=n_chroma,
    )
    ch_stats = chroma_stats(power, tb, n_valid, sr=sr, n_fft=n_fft, n_chroma=n_chroma)
    feats = torch.cat(
        [stats.reshape(B, 6 * n_mfcc), ch_stats, audio.new_zeros(B, 5)], dim=-1
    )
    return torch.where((n_valid >= 9)[:, None], feats, 0.0)


def pad_to_bucket(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n; clips beyond the largest bucket are cut to it."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def run_bucketed(
    clips: list[np.ndarray],
    batch_fn,
    out_dim: int,
    buckets=DEFAULT_BUCKETS,
    batch_size: int = 256,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Group clips by sample bucket, pad, run `batch_fn(audio [B, N],
    lengths [B]) -> [B, out_dim]` on `device`, and restore the order."""
    device = resolve_device(device)
    out = np.zeros((len(clips), out_dim), np.float32)
    by_bucket: dict[int, list[int]] = {}
    for i, y in enumerate(clips):
        by_bucket.setdefault(pad_to_bucket(len(y), buckets), []).append(i)
    for bucket, idxs in by_bucket.items():
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s : s + batch_size]
            batch = np.zeros((len(chunk), bucket), np.float32)
            lens = np.zeros(len(chunk), np.int32)
            for j, i in enumerate(chunk):
                y = clips[i][:bucket]
                batch[j, : len(y)] = y
                lens[j] = len(y)
            feats = batch_fn(torch.from_numpy(batch).to(device), torch.from_numpy(lens).to(device))
            out[chunk] = feats.cpu().numpy()
    return out


def batch_extractor_for(feature_cfg):
    """`batch_fn(audio [B, N], lengths [B]) -> [B, D]` for a FeatureConfig:
    the canonical 149-dim contract, or the 334-variant (main.py geometry,
    fixed semantics; its computed length is 286) when the config includes
    spectral contrast or the scalars."""
    fe = feature_cfg.frontend
    if feature_cfg.include_contrast or feature_cfg.include_scalars:
        from stutter_tpu_torch.ops.frontend334 import extract_features_334_batch as extract
    else:
        extract = extract_features_149_batch

    def batch_fn(audio, lengths):
        return extract(
            audio, lengths, sr=fe.sample_rate, n_fft=fe.n_fft, hop_length=fe.hop_length,
            n_mels=fe.n_mels, n_mfcc=fe.n_mfcc, n_chroma=fe.n_chroma,
        )

    return batch_fn


def extract_features_numpy(
    clips: list[np.ndarray],
    feature_cfg,
    buckets=DEFAULT_BUCKETS,
    batch_size: int = 256,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Clips -> [n, feature_cfg.total_feature_len] features on `device`."""
    return run_bucketed(clips, batch_extractor_for(feature_cfg), feature_cfg.total_feature_len,
                        buckets, batch_size, device)
