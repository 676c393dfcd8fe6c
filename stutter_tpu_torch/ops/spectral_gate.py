"""The non-stationary spectral gate on hop-chunked audio.

Replaces the TPU kernel `spectral_gate_pallas` (stutter_tpu/ops/pallas_denoise.py:265):
chunks [B, C, hop] of the padded signal -> the gate's overlap-added output
[B, T + ratio - 1, hop] before the crop (T = C - ratio + 1 frames).  The
gate is noisereduce's SpectralGateNonStationary: STFT, bidirectional
first-order IIR smoothing of |STFT|, sigmoid threshold mask, separable
triangular mask smoothing, prop_decrease blend, iSTFT.  A CUDA tensor
launches csrc/spectral_gate.cu (three launches: per-frame FFT analysis ->
|Y|; IIR + sigmoid mask per bin tile; smoothing, recomputed FFT, inverse FFT
and overlap-add per tile of output rows), for n_fft = 4 hop in 512, 1024,
2048; a CPU tensor runs the plain version.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from stutter_tpu_torch import _build
from stutter_tpu_torch.config import DenoiseConfig
from stutter_tpu_torch.ops import filterbanks as fb
from stutter_tpu_torch.ops.consts import (
    F32_TINY,
    FFT_SIZES,
    frame_tile,
    iir_bin_tile,
    iir_coefficient,
    mask_smoothing_profiles,
    ola_winv,
    rfft_twiddles,
    synth_row_tile,
    window_sumsquare,
)
from stutter_tpu_torch.ops.spectral import hann


def _affine_scan(a: torch.Tensor, u: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Inclusive scan of y[t] = a[t] * y[t -/+ 1] + u[t] along dim 1 by
    log-depth doubling."""
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
    """filtfilt([b], [1, b-1], x, axis=1) on [B, T, K] with steady-state
    starts: y[0] = x[0], y[t] = (1-b) y[t-1] + b x[t]; then backward."""
    T = x.shape[1]
    rows = torch.arange(T, device=x.device)[None, :, None]
    a0 = torch.where(rows == 0, 0.0, 1.0 - b).expand_as(x)
    fwd = _affine_scan(a0, torch.where(rows == 0, x, b * x), reverse=False)
    a1 = torch.where(rows == T - 1, 0.0, 1.0 - b).expand_as(x)
    return _affine_scan(a1, torch.where(rows == T - 1, fwd, b * fwd), reverse=True)


def smooth_mask(mask: torch.Tensor, cfg: DenoiseConfig) -> torch.Tensor:
    """Separable zero-padded 'same' smoothing of [B, T, K] with the
    triangular kernel: frequency taps first, then time taps."""
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


def spectral_gate_plain(
    chunks: torch.Tensor, n_fft: int, hop: int, cfg: DenoiseConfig
) -> torch.Tensor:
    """The plain PyTorch gate: rfft STFT -> IIR -> mask -> irfft OLA / wss."""
    B, C, _ = chunks.shape
    ratio = n_fft // hop
    T = C - ratio + 1
    win = hann(n_fft, chunks.device)
    frames = chunks.reshape(B, C * hop).unfold(-1, n_fft, hop)  # [B, T, n_fft]
    spec = torch.fft.rfft(frames * win, dim=-1)
    mag = torch.abs(spec)
    smooth = iir_smooth_bidirectional(mag, iir_coefficient(cfg))
    above = torch.where(
        smooth > 0, (mag - smooth) / torch.where(smooth > 0, smooth, 1.0), 0.0
    )
    mask = torch.sigmoid(
        (above - cfg.thresh_n_mult_nonstationary) * cfg.sigmoid_slope_nonstationary
    )
    mask = smooth_mask(mask, cfg)
    mask = mask * cfg.prop_decrease + (1.0 - cfg.prop_decrease)

    frames_t = torch.fft.irfft(spec * mask, n=n_fft, dim=-1) * win
    out = frames_t.new_zeros(B, (T + ratio - 1) * hop)
    for s in range(ratio):
        out[:, s * hop : s * hop + T * hop] += frames_t[:, :, s * hop : (s + 1) * hop].reshape(B, -1)
    wss = window_sumsquare(T, n_fft, hop)
    denom = torch.as_tensor(np.where(wss > F32_TINY, wss, 1.0), device=chunks.device)
    return (out / denom).reshape(B, T + ratio - 1, hop)


@lru_cache(maxsize=None)
def _device_tables(device: str, n_fft: int, cfg: DenoiseConfig) -> tuple:
    """Hann window, FFT twiddles and the smoothing taps, uploaded once per
    device and geometry."""
    profiles = mask_smoothing_profiles(cfg)
    f_taps, t_taps = profiles if profiles is not None else (np.ones(1), np.ones(1))
    host = (fb.hann(n_fft), rfft_twiddles(n_fft), f_taps, t_taps)
    return tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
                 for a in host)


@lru_cache(maxsize=None)
def _device_winv(device: str, t_frames: int, n_fft: int, hop: int) -> torch.Tensor:
    return torch.as_tensor(ola_winv(t_frames, n_fft, hop), device=device)


def _spectral_gate_cuda(chunks, n_fft, hop, cfg):
    B, C, h = chunks.shape
    ratio = n_fft // hop
    if h != hop or n_fft != 4 * hop or n_fft not in FFT_SIZES or C < ratio \
            or chunks.dtype != torch.float32:
        raise ValueError(f"spectral_gate kernel needs float32 [B, C, hop] chunks with "
                         f"n_fft == 4*hop, n_fft in {FFT_SIZES}; got {tuple(chunks.shape)}, "
                         f"n_fft={n_fft}")
    chunks = chunks.contiguous()
    T, K = C - ratio + 1, n_fft // 2 + 1
    dev = chunks.device
    win, tw, f_taps, t_taps = _device_tables(str(dev), n_fft, cfg)
    winv = _device_winv(str(dev), T, n_fft, hop)
    mag, mk = (torch.empty(B, T, K, device=dev) for _ in range(2))  # |Y| and the mask, scratch
    out = torch.empty(B, T + ratio - 1, hop, device=dev)
    b = iir_coefficient(cfg)
    tiles = (frame_tile(n_fft, T, B), iir_bin_tile(T, K, B),
             synth_row_tile(T + ratio - 1, B, n_fft, hop, f_taps.numel()))
    fn = _build.bind("spectral_gate", "spectral_gate_launch", 9, 9, 5)
    ptrs = [t.data_ptr() for t in (chunks, win, tw, f_taps, t_taps, winv, mag, mk, out)]
    rc = _build.launch(fn, chunks, *ptrs, B, C, n_fft, hop, f_taps.numel(), t_taps.numel(),
                       *tiles, b, 1.0 - b, cfg.thresh_n_mult_nonstationary,
                       cfg.sigmoid_slope_nonstationary, cfg.prop_decrease)
    _build.check(rc, "spectral_gate_launch")
    spectral_gate.launches += 1
    return out


def spectral_gate(
    chunks: torch.Tensor, n_fft: int, hop: int, cfg: DenoiseConfig
) -> torch.Tensor:
    """[B, C, hop] hop-chunked padded audio -> OLA output [B, C, hop] (that
    is [B, T + ratio - 1, hop]) == the gate's iSTFT / wss before the crop.
    A CUDA tensor launches the kernel; a CPU tensor runs the plain version."""
    if chunks.is_cuda:
        return _spectral_gate_cuda(chunks, n_fft, hop, cfg)
    if chunks.device.type == "cpu":
        return spectral_gate_plain(chunks, n_fft, hop, cfg)
    raise ValueError(f"spectral_gate: no kernel for device {chunks.device}")


spectral_gate.launches = 0  # kernel launches of this wrapper, read by chip_smoke.py
