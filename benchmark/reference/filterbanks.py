"""Frozen copy of stutter_tpu_torch/ops/filterbanks.py (the port's plain version), for the benchmark's reference.

Host-side filterbanks and linear operators of the front end, in float64
NumPy (counterpart of stutter_tpu/ops/filterbanks.py, with the NumPy oracle
functions of stutter_tpu/oracle/frontend.py that they call).

Periodic Hann window, Slaney mel filterbank, orthonormal DCT-II,
Savitzky-Golay delta operators (interior kernel + edge-projection matrices)
and the table of the 100 tuning-shifted chroma filterbanks (librosa's tuning
estimate is quantised to 0.01-octave bins, so the whole family is
enumerable).  librosa itself is not a dependency: every formula is written
out, as in the JAX package, and tests/test_torch_isolation.py holds each
table equal to the JAX package's.

The SavGol operators come from applying scipy.signal.savgol_filter to
impulse and identity inputs, which makes the edge ('interp') semantics
exact by construction.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import scipy.signal

# ---------------------------------------------------------------------------
# NumPy oracle functions (librosa semantics)
# ---------------------------------------------------------------------------


def hann_window(n: int) -> np.ndarray:
    """Periodic ("fftbins") Hann window, as scipy.signal.get_window('hann', n)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def hz_to_mel(freq: np.ndarray, htk: bool = False) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz, min_log_mel + np.log(np.maximum(freq, 1e-30) / min_log_hz) / logstep, mels
    )


def mel_to_hz(mels: np.ndarray, htk: bool = False) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, [n_mels, 1 + n_fft//2].

    Matches librosa.filters.mel(norm='slaney', htk=False).
    """
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def dct_ortho_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_out, n_in]: out = M @ x (scipy dct type 2)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    M = 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    scale = np.full((n_out, 1), np.sqrt(1.0 / (2.0 * n_in)))
    scale[0, 0] = np.sqrt(1.0 / (4.0 * n_in))
    return (M * scale).astype(np.float64)


def hz_to_octs(freq: np.ndarray, tuning: float = 0.0, bins_per_octave: int = 12) -> np.ndarray:
    A440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return np.log2(np.asarray(freq, dtype=np.float64) / (A440 / 16.0))


def chroma_filterbank(
    sr: int,
    n_fft: int,
    n_chroma: int = 12,
    tuning: float = 0.0,
    ctroct: float = 5.0,
    octwidth: float = 2.0,
    base_c: bool = True,
) -> np.ndarray:
    """librosa.filters.chroma: Gaussian-bump chroma projection, [n_chroma, 1+n_fft//2].

    Each FFT bin's column is L2-normalised across the chroma axis (librosa's
    default norm=2), then weighted by a Gaussian over octaves centred at
    ctroct.
    """
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    frqbins = n_chroma * hz_to_octs(frequencies, tuning=tuning, bins_per_octave=n_chroma)
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    wts = wts / np.maximum(
        np.sqrt(np.sum(wts**2, axis=0, keepdims=True)), np.finfo(np.float64).tiny
    )
    if octwidth is not None:
        wts *= np.tile(
            np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)), (n_chroma, 1)
        )
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : int(1 + n_fft / 2)], dtype=np.float32)


# ---------------------------------------------------------------------------
# Cached tables of the front end
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SavgolOps:
    """Linear operators for savgol_filter(width, polyorder=order, deriv=order,
    mode='interp') along time.

    interior: [width] correlation kernel, y[t] = sum_k kernel[k] * x[t+k-half]
    first / last: [half, width] edge matrices applied to the first/last `width`
    valid samples.
    """

    interior: np.ndarray
    first: np.ndarray
    last: np.ndarray
    width: int


@lru_cache(maxsize=None)
def savgol_ops(width: int = 9, order: int = 1) -> SavgolOps:
    half = width // 2
    # interior kernel from the impulse response in a long signal: with
    # x = e_c, the correlation y[t] = sum_j kernel[j] x[t + j - half] gives
    # y[t] = kernel[c - t + half]
    n = 4 * width + 1
    impulse = np.zeros(n)
    impulse[n // 2] = 1.0
    resp = scipy.signal.savgol_filter(impulse, width, polyorder=order, deriv=order,
                                      mode="interp")
    c = n // 2
    kernel = np.array([resp[c - j + half] for j in range(width)])
    # edge matrices: savgol_filter of eye(width) columns; on a width-length
    # signal, mode='interp' fits one polynomial to the whole window, and the
    # first/last `half` outputs equal the long-signal edge outputs
    K = np.stack(
        [scipy.signal.savgol_filter(e, width, polyorder=order, deriv=order, mode="interp")
         for e in np.eye(width)],
        axis=1,
    )  # K[t, j]: output t from input basis j
    return SavgolOps(
        interior=kernel.astype(np.float32),
        first=K[:half].astype(np.float32),
        last=K[-half:].astype(np.float32),
        width=width,
    )


@lru_cache(maxsize=None)
def hann(win_length: int) -> np.ndarray:
    return hann_window(win_length)


@lru_cache(maxsize=None)
def mel_fb(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
           fmax: float | None = None) -> np.ndarray:
    """[n_mels, n_freqs] Slaney mel filterbank (float32)."""
    return mel_filterbank(sr, n_fft, n_mels, fmin, fmax)


@lru_cache(maxsize=None)
def dct_mat(n_mfcc: int, n_mels: int) -> np.ndarray:
    """[n_mfcc, n_mels] orthonormal DCT-II matrix (float32)."""
    return dct_ortho_matrix(n_mfcc, n_mels).astype(np.float32)


@lru_cache(maxsize=None)
def tuning_bin_edges(resolution: float = 0.01) -> np.ndarray:
    """The histogram bin edges librosa.pitch_tuning uses (float64)."""
    return np.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1)


@lru_cache(maxsize=None)
def chroma_fb_table(
    sr: int, n_fft: int, n_chroma: int = 12, resolution: float = 0.01
) -> np.ndarray:
    """[n_bins, n_chroma, n_freqs] chroma filterbanks, one per tuning bin.

    librosa's estimated tuning is always a histogram bin left edge
    (pitch_tuning returns edges[argmax]), so enumerating the 100 possible
    filterbanks turns the signal-dependent filterbank into a table lookup.
    Row i corresponds to tuning = edges[i].
    """
    edges = tuning_bin_edges(resolution)[:-1]  # left edges, 100 values
    table = np.stack(
        [chroma_filterbank(sr, n_fft, n_chroma=n_chroma, tuning=float(t)) for t in edges],
        axis=0,
    )
    return table.astype(np.float32)
