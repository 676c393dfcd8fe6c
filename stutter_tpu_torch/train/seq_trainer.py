"""Sequence featurization and inference for the sequence heads (the
inference half of stutter_tpu/train/seq_trainer.py; training is not
ported yet).

Log-mel frames (n_fft 2048, hop 512, 128 Slaney mels, librosa's per-clip
80 dB clamp) for the CNN and the transformers, the 20-MFCC + delta +
delta2 stack for the CNN-BiLSTM.  The power spectrum and the mel come from
the spectromel kernel's mel-output mode (`ops.frontend.spect_mel_db`)
without its tuning tail, which nothing here reads; in the JAX package they
are XLA's power_spectrogram and mel_power_to_db, the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.ops.delta import sg_deltas
from stutter_tpu_torch.ops.frontend import DEFAULT_BUCKETS, pad_to_bucket, spect_mel_db
from stutter_tpu_torch.ops.spectral import mfcc_from_db

FEATURE_DIMS = {"logmel": 128, "mfcc_deltas": 60}


def frames_from_db(db: torch.Tensor, n_valid: torch.Tensor, kinds) -> dict[str, torch.Tensor]:
    """Log-mel [B, T, 128] (n_valid [B] valid frames) -> {kind: [B, T, D]}
    for each of `kinds`: the log-mel itself, or MFCC + delta + delta2."""
    out = {}
    if "logmel" in kinds:
        out["logmel"] = db
    if "mfcc_deltas" in kinds:
        mf = mfcc_from_db(db, 20)
        d1, d2 = sg_deltas(mf, n_valid, orders=(1, 2))
        out["mfcc_deltas"] = torch.cat([mf, d1, d2], dim=-1)
    return out


def seq_frames(audio: torch.Tensor, lengths: torch.Tensor, kinds, sr: int = 16000):
    """[B, N] zero-padded audio, lengths [B] -> ({kind: frames [B, T, D]},
    frame mask [B, T]), every kind from one spectrogram; T = 1 + N // 512."""
    _, mask, db, _ = spect_mel_db(audio, lengths, sr, 2048, 512, 128, with_tuning=False)
    return frames_from_db(db, 1 + torch.div(lengths, 512, rounding_mode="floor"), kinds), mask


def _featurize_seq(audio: torch.Tensor, lengths: torch.Tensor, kind: str, sr: int = 16000):
    """One kind's (frames [B, T, D], frame mask [B, T])."""
    frames, mask = seq_frames(audio, lengths, (kind,), sr)
    return frames[kind], mask


def fit_frames(f: torch.Tensor, t_max: int) -> torch.Tensor:
    """[B, T, D] -> [B, t_max, D]: cut, or zero-padded at the end."""
    T = f.shape[1]
    return f[:, :t_max] if T >= t_max else torch.nn.functional.pad(f, (0, 0, 0, t_max - T))


def prepare_sequence_dataset(
    clips: list[np.ndarray],
    kind: str = "logmel",
    sr: int = 16000,
    t_max: int = 316,
    batch: int = 128,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """clips -> (features [N, t_max, D], n_valid [N]) on the host, padded or
    cut to t_max frames; each bucket of clips featurized in batches on
    `device`.  kind='logmel': D = 128; kind='mfcc_deltas': D = 60."""
    device = resolve_device(device)
    out = np.zeros((len(clips), t_max, FEATURE_DIMS[kind]), np.float32)
    n_valid = np.zeros(len(clips), np.int32)
    by_bucket: dict[int, list[int]] = {}
    for i, y in enumerate(clips):
        by_bucket.setdefault(pad_to_bucket(len(y), DEFAULT_BUCKETS), []).append(i)
    for bucket, idxs in by_bucket.items():
        for s in range(0, len(idxs), batch):
            chunk = idxs[s : s + batch]
            buf = np.zeros((len(chunk), bucket), np.float32)
            lens = np.zeros(len(chunk), np.int32)
            for j, i in enumerate(chunk):
                y = clips[i][:bucket]
                buf[j, : len(y)] = y
                lens[j] = len(y)
            with torch.no_grad():
                feats, _ = _featurize_seq(torch.from_numpy(buf).to(device),
                                          torch.from_numpy(lens).to(device), kind, sr)
            feats = feats.cpu().numpy()
            for j, i in enumerate(chunk):
                t = min(1 + int(lens[j]) // 512, t_max)
                out[i, :t] = feats[j, :t]
                n_valid[i] = t
    return out, n_valid


def standardize_sequences(X: np.ndarray, n_valid: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-feature standardization over valid frames; returns (Xs, mean, std)."""
    mask = (np.arange(X.shape[1])[None, :] < n_valid[:, None])[..., None]
    cnt = mask.sum()
    mean = (X * mask).sum(axis=(0, 1)) / cnt
    var = (((X - mean) * mask) ** 2).sum(axis=(0, 1)) / cnt
    std = np.sqrt(np.maximum(var, 1e-12))
    return ((X - mean) / std * mask).astype(np.float32), mean, std


def predict_sequence_model(
    model: torch.nn.Module, X: np.ndarray, n_valid: np.ndarray, batch: int = 256,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Standardized [N, T, D] frames + n_valid [N] -> probabilities [N, C],
    in batches on `device` (where `model`'s weights lie)."""
    device = resolve_device(device)
    N, T, _ = X.shape
    outs = []
    with torch.no_grad():
        for s in range(0, N, batch):
            nv = np.asarray(n_valid[s : s + batch])
            mb = torch.arange(T)[None, :] < torch.from_numpy(nv.astype(np.int64))[:, None]
            logits = model(torch.from_numpy(np.ascontiguousarray(X[s : s + batch])).to(device),
                           mb.to(device), nv)
            outs.append(torch.softmax(logits, -1).cpu().numpy())
    return np.concatenate(outs, axis=0)
