"""Fused STFT power + mel or MFCC/delta statistics + piptrack tuning.

Replaces the TPU kernel `spectromel_pallas(with_tuning=True)`
(stutter_tpu/ops/pallas_spectromel.py:409) in both of its modes.  For a
batch of zero-padded clips it returns the frame-masked power spectrogram
[B, T, K], then either (with_stats=True, the 149-dim front end) the
MFCC/delta statistics [B, 6, n_mfcc] (rows: mfcc mean/std, delta mean/std,
delta2 mean/std over valid frames) or (with_stats=False, the mel-output mode
of the 286-dim variant) the linear mel spectrum [B, T, n_mels], and the
librosa tuning bin [B] (with_tuning=True; the mel mode may skip it, as the
sequence featurizer does, and then returns None for it).

`spectromel` dispatches on where the audio lies: a CPU tensor runs
`spectromel_plain`; a CUDA tensor launches csrc/spectromel.cu (per frame
tile: the shared-memory FFT, power, mel over each band's nonzero bins and
the piptrack candidates, compacted per frame as
`ops.chroma.compact_candidates` lays them out; in stats mode
dB/DCT/SavGol/stats per clip; the tuning bin per clip from the compacted
candidates, as `ops.chroma.tuning_bin_from_compacted` computes it).  The
kernel takes n_fft in 512, 1024, 2048 and any hop >= 2 that divides n_fft
and the bucket, in both modes.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from stutter_tpu_torch.ops import filterbanks as fb
from stutter_tpu_torch import _build
from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
from stutter_tpu_torch.ops.consts import (
    FFT_SIZES,
    PIP_FMAX,
    PIP_FMIN,
    band_range,
    frame_tile,
    mel_sparse,
    residual_table,
    rfft_twiddles,
    savgol_taps,
)
from stutter_tpu_torch.ops.delta import sg_deltas
from stutter_tpu_torch.ops.masked import frame_mask, masked_mean_std
from stutter_tpu_torch.ops.spectral import (
    mel_filterbank,
    mel_power_to_db,
    mfcc_from_db,
    power_spectrogram,
)


def spectromel_plain(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    n_mfcc: int = 20,
    n_chroma: int = 12,
    with_stats: bool = True,
    with_tuning: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The plain PyTorch composition the kernel computes (rfft power)."""
    power = power_spectrogram(audio, n_fft, hop_length)
    mask = frame_mask(lengths, hop_length, power.shape[1])
    power = torch.where(mask[:, :, None], power, 0.0)
    if not with_stats:
        mel = torch.matmul(power, mel_filterbank(sr, n_fft, n_mels, power.device).T)
        return power, mel, estimate_tuning_bin(power, sr, n_fft, n_chroma) if with_tuning else None
    mf = mfcc_from_db(mel_power_to_db(power, mask, sr, n_fft, n_mels), n_mfcc)
    n_valid = 1 + torch.div(lengths, hop_length, rounding_mode="floor")
    d1, d2 = sg_deltas(mf, n_valid, orders=(1, 2))
    rows = []
    for x in (mf, d1, d2):
        rows.extend(masked_mean_std(x, mask, axis=1))
    stats = torch.stack(rows, dim=1)  # [B, 6, n_mfcc]
    return power, stats, estimate_tuning_bin(power, sr, n_fft, n_chroma)


@lru_cache(maxsize=None)
def _device_tables(device: str, sr: int, n_fft: int, n_mels: int, n_mfcc: int,
                   n_chroma: int) -> tuple[torch.Tensor, ...]:
    """The kernel's constant tables, uploaded once per device and geometry:
    Hann window, FFT twiddles, sparse mel ranges (int32) and weights, the
    pitch residual table, the DCT and the SavGol taps."""
    ranges, weights = mel_sparse(sr, n_fft, n_mels)
    dct_t = fb.dct_mat(n_mfcc, n_mels).T  # [M, n_mfcc]
    host = (fb.hann(n_fft), rfft_twiddles(n_fft), ranges, weights,
            residual_table(sr, n_fft, n_fft // 2 + 1, n_chroma), dct_t, savgol_taps())
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in host)


def _spectromel_cuda(audio, lengths, sr, n_fft, hop, n_mels, n_mfcc, n_chroma, with_stats,
                     with_tuning):
    B, N = audio.shape
    # the plain version's framing needs hop | N and hop | n_fft; the kernel
    # stages frames 8-byte aligned, so hop >= 2
    if n_fft not in FFT_SIZES or hop < 2 or N % hop or n_fft % hop:
        raise ValueError(f"spectromel kernel needs n_fft in {FFT_SIZES}, hop | N, hop | n_fft "
                         f"and hop >= 2; got n_fft={n_fft} hop={hop} N={N}")
    T, K = N // hop + 1, n_fft // 2 + 1
    if with_stats and 12 * T * n_mfcc > 232448:
        raise ValueError(f"spectromel stats mode: {T} frames x {n_mfcc} MFCC exceed a block's "
                         f"shared memory")
    if audio.dtype != torch.float32 or lengths.device != audio.device:
        raise ValueError("spectromel kernel takes float32 audio and lengths on its device")
    audio = audio.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    lo, hi = band_range(sr, n_fft, PIP_FMIN, PIP_FMAX)
    win, tw, ranges, weights, rtab, dct_t, sg = _device_tables(
        str(audio.device), sr, n_fft, n_mels, n_mfcc, n_chroma)
    dev = audio.device
    power = torch.empty(B, T, K, device=dev)
    mel = torch.empty(B, T, n_mels, device=dev)
    # compacted candidates: per frame `cap` slots of u32 keys (held as int32)
    # and u8 bins, filled up to the frame's count
    cap = (hi - lo + 1) // 2
    keys = torch.empty(B, T, cap, dtype=torch.int32, device=dev)
    bins = torch.empty(B, T, cap, dtype=torch.uint8, device=dev)
    counts = torch.empty(B, T, dtype=torch.int32, device=dev)
    tb = torch.empty(B, dtype=torch.int32, device=dev) if with_tuning else None
    # the series factor is rounded to f32 exactly as the plain version's
    # Python-float scalar is
    c_ln2 = n_chroma / math.log(2.0)
    tile = frame_tile(n_fft, T, B)
    if not with_stats:
        fn = _build.bind("spectromel", "spectromel_mel_launch", 13, 8, 1)
        # a null tuning-bin pointer skips the tail launch
        ptrs = [t.data_ptr() for t in (audio, lengths, win, tw, ranges, weights, rtab, power,
                                       mel, keys, bins, counts)] + [tb.data_ptr() if with_tuning
                                                                    else None]
        rc = _build.launch(fn, audio, *ptrs, B, N, n_fft, hop, tile, n_mels, lo, hi, c_ln2)
        _build.check(rc, "spectromel_mel_launch")
        spectromel.mel_launches += 1
        return power, mel, tb
    stats = torch.empty(B, 6, n_mfcc, device=dev)
    fn = _build.bind("spectromel", "spectromel_launch", 16, 9, 1)
    ptrs = [t.data_ptr() for t in (audio, lengths, win, tw, ranges, weights, rtab, dct_t, sg,
                                   power, mel, keys, bins, counts, stats, tb)]
    rc = _build.launch(fn, audio, *ptrs, B, N, n_fft, hop, tile, n_mels, n_mfcc, lo, hi, c_ln2)
    _build.check(rc, "spectromel_launch")
    spectromel.launches += 1
    return power, stats, tb


def spectromel(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    n_mfcc: int = 20,
    n_chroma: int = 12,
    with_stats: bool = True,
    with_tuning: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """[B, N] zero-padded audio (N a multiple of hop) + lengths [B] ->
    (power [B, T, K] frame-masked, stats [B, 6, n_mfcc] or, with
    with_stats=False, mel [B, T, n_mels], tuning_bin [B] int32 or, with
    with_tuning=False (mel mode only: the tail's launch is skipped), None).

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version."""
    if with_stats and not with_tuning:
        raise ValueError("with_stats requires with_tuning")
    args = (audio, lengths, sr, n_fft, hop_length, n_mels, n_mfcc, n_chroma, with_stats,
            with_tuning)
    if audio.is_cuda:
        return _spectromel_cuda(*args)
    if audio.device.type == "cpu":
        return spectromel_plain(*args)
    raise ValueError(f"spectromel: no kernel for device {audio.device}")


# kernel launches of this wrapper per mode, read by chip_smoke.py
spectromel.launches = 0  # stats mode
spectromel.mel_launches = 0  # mel-output mode
