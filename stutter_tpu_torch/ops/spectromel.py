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
the dB clamp, DCT, SavGol deltas and stats by a cluster of blocks per
clip, laid out by `stats_plan`; the tuning bin per clip from the compacted
candidates, as `ops.chroma.tuning_bin_from_compacted` computes it).  The
kernel takes n_fft in 512, 1024, 2048 and any hop >= 2 that divides n_fft
and the bucket, in both modes.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

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


SMEM_LIMIT = 232448  # bytes of shared memory a block can have on an H100
STATS_THREADS = 256  # csrc/spectromel.cu: threads of a stats block
MAX_CLUSTER = 8  # blocks of a portable cluster
# blocks the stats launch aims at, about one on each of an H100's 132 SMs:
# the best of 1, 2, 4 and 8 blocks a clip at B=256 x 3 s, B=64 x 48,128
# samples and one 3 s request (tools/kernel_phases.py --stats-plans, PERF.md)
STATS_BLOCKS = 128
MIN_FRAMES = 8  # the fewest frames worth a block of its own
SG_WIDTH = 9  # the SavGol window
DCT_CHUNK = 20  # coefficients a warp's DCT tile spans (csrc/spectromel.cu: CHUNK)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def stats_smem_bytes(rows: int, n_mels: int = 128, n_mfcc: int = 20) -> int:
    """Shared memory of a stats block that owns `rows` frames, as
    csrc/spectromel.cu:stats_layout lays it out: the mbarrier; every warp's
    max of every rank; the dB mel rows it transforms (its frames, 8 before
    and 4 after: `StatsPlan.window`), each padded by 4 floats (after the DCT
    the same bytes hold the deltas); the DCT table [n_mfcc rounded up to 20,
    n_mels + 4]; those rows' MFCC."""
    w = rows + 12
    floats = (4 + MAX_CLUSTER * STATS_THREADS // 32
              + _round4(max(w * (n_mels + 4), 2 * rows * n_mfcc))
              + _dct_rows(n_mfcc) * (n_mels + 4) + _round4(w * n_mfcc))
    return 4 * floats


def _dct_rows(n_mfcc: int) -> int:
    """Rows of the stats launch's DCT table: n_mfcc rounded up to the
    DCT_CHUNK coefficients a warp's tile spans."""
    return -(-n_mfcc // DCT_CHUNK) * DCT_CHUNK


class StatsPlan(NamedTuple):
    """The stats launch's layout: `cs` blocks (a cluster) per clip, block q
    owning the valid frames [q * rows, (q + 1) * rows), and each block's
    shared memory in bytes."""

    cs: int
    rows: int
    smem: int

    def ranges(self, n_valid: int, T: int) -> list[tuple[int, int]]:
        """Each block's own frames [start, end) of a clip of n_valid valid
        frames in a bucket of T: it forms their deltas and partial sums."""
        nv = min(n_valid, T)
        return [(min(q * self.rows, nv), min((q + 1) * self.rows, nv)) for q in range(self.cs)]

    def window(self, q: int, n_valid: int, T: int) -> tuple[int, int]:
        """The frames [lo, hi) block q transforms: its own, the 8 before
        (the interior rows' halo of 4, and a last-edge window that starts up
        to 8 frames back), the 4 after, rows 0-8 for the first edge and, for
        a clip of fewer than 9 frames, the masked frames up to 9 that its
        last-edge rows read; (lo, lo) for a block without valid frames."""
        start, end = self.ranges(n_valid, T)[q]
        lo = max(0, q * self.rows - 8)
        if end == start:
            return lo, lo
        return lo, min(min(max(n_valid, SG_WIDTH), T), max(end + 4, SG_WIDTH))


def stats_plan(B: int, T: int, n_mels: int = 128, n_mfcc: int = 20) -> StatsPlan:
    """Blocks per clip and frames per block of the stats launch for B clips
    in a bucket of T frames (any of which may be valid: the lengths stay on
    the card): up to 8 blocks (a portable cluster), STATS_BLOCKS over the
    batch, no fewer than MIN_FRAMES frames a block, and more blocks where a
    block's rows would not fit its shared memory.  Raises ValueError where
    the launch cannot take the bucket."""
    if T < SG_WIDTH or n_mels < 4 or n_mels % 4 or n_mfcc < 1:
        raise ValueError(f"spectromel stats mode needs at least {SG_WIDTH} frames and n_mels a "
                         f"multiple of 4; got T={T} n_mels={n_mels} n_mfcc={n_mfcc}")
    cs = max(1, min(MAX_CLUSTER, -(-STATS_BLOCKS // B), -(-T // MIN_FRAMES)))
    while cs < MAX_CLUSTER and stats_smem_bytes(-(-T // cs), n_mels, n_mfcc) > SMEM_LIMIT:
        cs += 1
    rows = -(-T // cs)
    smem = stats_smem_bytes(rows, n_mels, n_mfcc)
    if smem > SMEM_LIMIT:
        raise ValueError(f"spectromel stats mode: {T} frames x {n_mels} mels exceed the shared "
                         f"memory of a cluster of {MAX_CLUSTER} blocks")
    return StatsPlan(cs, rows, smem)


@lru_cache(maxsize=None)
def _device_tables(device: str, sr: int, n_fft: int, n_mels: int, n_mfcc: int,
                   n_chroma: int) -> tuple[torch.Tensor, ...]:
    """The kernel's constant tables, uploaded once per device and geometry:
    Hann window, FFT twiddles, sparse mel ranges (int32) and weights, the
    pitch residual table, the DCT [n_mfcc rounded up to 20, n_mels + 4]
    (zero past n_mfcc and n_mels: the stats launch's shared-memory layout)
    and the SavGol taps."""
    ranges, weights = mel_sparse(sr, n_fft, n_mels)
    dct = np.zeros((_dct_rows(n_mfcc), n_mels + 4), np.float32)
    dct[:n_mfcc, :n_mels] = fb.dct_mat(n_mfcc, n_mels)
    host = (fb.hann(n_fft), rfft_twiddles(n_fft), ranges, weights,
            residual_table(sr, n_fft, n_fft // 2 + 1, n_chroma), dct, savgol_taps())
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
    plan = stats_plan(B, T, n_mels=n_mels, n_mfcc=n_mfcc) if with_stats else None
    if audio.dtype != torch.float32 or lengths.device != audio.device:
        raise ValueError("spectromel kernel takes float32 audio and lengths on its device")
    audio = audio.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    lo, hi = band_range(sr, n_fft, PIP_FMIN, PIP_FMAX)
    win, tw, ranges, weights, rtab, dct, sg = _device_tables(
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
    fn = _build.bind("spectromel", "spectromel_launch", 16, 11, 1)
    ptrs = [t.data_ptr() for t in (audio, lengths, win, tw, ranges, weights, rtab, dct, sg,
                                   power, mel, keys, bins, counts, stats, tb)]
    rc = _build.launch(fn, audio, *ptrs, B, N, n_fft, hop, tile, n_mels, n_mfcc, plan.cs,
                       plan.rows, lo, hi, c_ln2)
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
