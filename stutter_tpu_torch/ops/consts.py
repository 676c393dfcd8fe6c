"""Host-side constant tables of the port, built in float64 NumPy, kept
float32, and the launch geometry of the FFT kernels.

The JAX package builds its tables inside modules that import JAX
(ops/spectral, denoise, ops/chroma, ops/pallas_*), and splits several into
bf16 hi/lo pairs for the TPU's matrix unit.  The port needs the same tables
without JAX and uses them whole in FP32, so they are rebuilt here from the
same formulas; tests/test_torch_consts.py holds each against its JAX
original.  The kernels' own tables (FFT twiddles, the sparse mel ranges)
have no JAX original: tests/test_torch_fft.py holds them to np.fft and to
mel_fb.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from stutter_tpu_torch.config import DenoiseConfig
from stutter_tpu_torch.ops import filterbanks as fb

F32_TINY = float(np.finfo(np.float32).tiny)
TUNE_BINS = 100  # ceil(1 / resolution) at librosa's resolution 0.01
TUNE_THRESHOLD = 0.1  # librosa piptrack default
PIP_FMIN, PIP_FMAX = 150.0, 4000.0  # librosa estimate_tuning's piptrack band

# launch geometry of the FFT kernels (csrc/rfft_smem.cuh)
NUM_SMS = 132  # an H100 SXM: the block count a launch should reach
FFT_SIZES = (512, 1024, 2048)  # the n_fft the kernels are built for
TILE_POINTS = 4096  # complex FFT points a block holds: TILE_POINTS // (n_fft // 2) frames
IIR_SMEM = 113 * 1024  # bytes of a gate IIR tile ([T, KB] |Y| + scan), two blocks an SM
SYNTH_SMEM = 224 * 1024  # dynamic shared memory of a gate synthesis block (static: 2.5 KB)


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


@lru_cache(maxsize=None)
def rfft_twiddles(n_fft: int) -> np.ndarray:
    """[n_fft, 2] f32: w^s = e^{-2 pi i s / n_fft} for s < n_fft, computed in
    float64 and rounded once; values within 1e-12 of 0 (at multiples of a
    quarter turn) are exact zeros.  The shared-memory FFT reads its radix
    twiddles w_M^t = w^{2t} and the real split's w^k from it."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    tab = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    tab[np.abs(tab) < 1e-12] = 0.0
    return tab.astype(np.float32)


@lru_cache(maxsize=None)
def mel_sparse(sr: int, n_fft: int, n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """The mel filterbank by band: (ranges [n_mels, 3] int32 -- first bin,
    number of bins, offset into the weights -- and the weights f32), each
    band's range from its first to its last nonzero weight (length 0 for a
    band with none).  Scattering the weights back rebuilds fb.mel_fb
    exactly."""
    dense = fb.mel_fb(sr, n_fft, n_mels)
    ranges, weights, off = [], [], 0
    for row in dense:
        nz = np.flatnonzero(row)
        start, length = (int(nz[0]), int(nz[-1]) - int(nz[0]) + 1) if nz.size else (0, 0)
        ranges.append((start, length, off))
        weights.append(row[start : start + length])
        off += length
    return np.asarray(ranges, np.int32), np.concatenate(weights).astype(np.float32)


def pick_tile(n: int, batch: int, tiles) -> int:
    """The largest tile in `tiles` (descending) at which `batch` x ceil(n /
    tile) blocks still reach NUM_SMS, else the smallest: big tiles for a
    batch, small ones so that a single clip still spreads over the SMs."""
    for t in tiles:
        if batch * -(-n // t) >= NUM_SMS:
            return t
    return tiles[-1]


def tile_ranges(n: int, tile: int) -> list[tuple[int, int]]:
    """[start, stop) of each block's tile, as the kernels cut them: block i
    takes items i * tile ... min((i + 1) * tile, n) - 1."""
    return [(t0, min(t0 + tile, n)) for t0 in range(0, n, tile)]


def frame_tile(n_fft: int, n_frames: int, batch: int) -> int:
    """Frames per block of the FFT frame kernels (spectromel launch 1, the
    gate's analysis): a power of two up to TILE_POINTS // (n_fft // 2)."""
    tiles, t = [], TILE_POINTS // (n_fft // 2)
    while t >= 1:
        tiles.append(t)
        t //= 2
    return pick_tile(n_frames, batch, tiles)


def iir_bin_tile(n_frames: int, n_bins: int, batch: int) -> int:
    """Bins per block of the gate's IIR launch: a power of two from 8 down
    to 2 whose [T, KB] tile (|Y| and the scan, 8 T KB bytes) fits
    IIR_SMEM."""
    fits = [kb for kb in (8, 4, 2) if 8 * n_frames * kb <= IIR_SMEM] or [2]
    return pick_tile(n_bins, batch, fits)


def synth_smem_bytes(n_fft: int, hop: int, rows: int, kf: int) -> int:
    """Shared memory of a gate synthesis block of `rows` output rows (as
    csrc/spectral_gate.cu:SynthLayout lays it out): rows + 3 frames, either
    as padded FFT frames plus their audio span or as mask rows with the
    frequency halo in 4 planes, then the blended mask."""
    M, nf = n_fft // 2, rows + 3
    planes = (M + 1 + kf + 9) // 4
    frame, span = 2 * (M + M // 16), (nf - 1) * hop + 2 * M
    group = TILE_POINTS // M
    last_group = group * ((nf - 1) // group)
    # the span shares the last FFT group's frames when it fits there
    span_end = nf * frame + (0 if span <= (nf - last_group) * frame else span)
    return 4 * (max(nf * 4 * planes, span_end) + nf * (M + 1))


def synth_row_tile(n_rows: int, batch: int, n_fft: int = 1024, hop: int = 256,
                   kf: int = 33) -> int:
    """Output hop-rows per block of the gate's synthesis launch: 13 (16
    frames, whole FFT groups) down to 1, among those whose block fits the
    shared memory."""
    fits = [t for t in (13, 8, 4, 2, 1) if synth_smem_bytes(n_fft, hop, t, kf) <= SYNTH_SMEM]
    return pick_tile(n_rows, batch, fits)


def synth_frames(r0: int, tt: int, n_frames: int, ratio: int = 4) -> tuple[int, int]:
    """[fa, fb): the frames the synthesis block of rows r0 .. r0 + tt - 1
    recomputes -- every frame r - s (s < ratio) of its rows that exists."""
    return max(r0 - (ratio - 1), 0), min(r0 + tt, n_frames)
