"""Non-stationary spectral-gating denoiser, noisereduce-equivalent
(counterpart of stutter_tpu/denoise.py).

The reference cleans every clip with noisereduce.reduce_noise followed by
peak normalisation (pipeline1.py:140-142).  `denoise_batch` pads each clip
by noisereduce's 30000-sample chunk padding, runs the gate on the hop
chunks (ops/spectral_gate.py: the CUDA kernel for CUDA tensors), crops, and
peak-normalises over each clip's valid samples.  Trailing batch padding is
zeros, which the gate maps to zeros, so batched output equals per-clip
output.
"""

from __future__ import annotations

import numpy as np
import torch

from stutter_tpu_torch.config import DenoiseConfig
from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.ops.consts import F32_TINY
from stutter_tpu_torch.ops.frontend import bucket_groups, host_batches
from stutter_tpu_torch.ops.spectral_gate import spectral_gate
from stutter_tpu_torch.utils.profiling import span

PAD = 30000  # noisereduce chunk padding (samples)


def denoise_batch(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    cfg: DenoiseConfig = DenoiseConfig(),
    gate=spectral_gate,
) -> torch.Tensor:
    """audio [B, N] (zero-padded), lengths [B] -> denoised, peak-normalised [B, N].

    `gate` lets a comparison run spectral_gate_plain on CUDA tensors."""
    B, N = audio.shape
    hop, n_fft = cfg.hop_length, cfg.n_fft
    # the clip sits after PAD zeros; extend so the frames cover N + 2 * PAD,
    # then add the STFT's centre padding and cut into hop chunks
    buf_len = -(-(N + 2 * PAD) // hop) * hop
    x = torch.nn.functional.pad(audio, (PAD + n_fft // 2, buf_len - N - PAD + n_fft // 2))
    y = gate(x.reshape(B, -1, hop), n_fft, hop, cfg).reshape(B, -1)
    # OLA sample m is x[m - n_fft//2], and x[n] is clip sample n - PAD
    y = y[:, n_fft // 2 + PAD : n_fft // 2 + PAD + N]

    # librosa.util.normalize: peak over the clip's valid samples
    sample_mask = torch.arange(N, device=audio.device)[None, :] < lengths[:, None]
    y = torch.where(sample_mask, y, 0.0)
    peak = torch.amax(torch.abs(y), dim=1, keepdim=True)
    peak = torch.where(peak > F32_TINY, peak, 1.0)
    return y / peak


def denoise_clips(
    clips: list[np.ndarray],
    cfg: DenoiseConfig = DenoiseConfig(),
    batch_size: int = 64,
    device: torch.device | str = "cuda",
) -> list[np.ndarray]:
    """Host wrapper: denoise a list of 1-D clips, in the batches of
    ops.frontend.bucket_groups, on `device` (ops.frontend.host_batches).
    A clip longer than the largest bucket is padded to a multiple of it and
    comes back whole.
    Traced, the call is the span `denoise_clips`, each batch's leaves pad,
    h2d, `denoise_batch` (the launches), d2h and unpad."""
    device = resolve_device(device)
    out: list[np.ndarray | None] = [None] * len(clips)
    groups = bucket_groups([len(y) for y in clips], batch_size, whole=True)
    # denoise_batch is looked up at each call, so a replacement of it is what runs
    for chunk, lens, cleaned in host_batches("denoise_clips", clips, groups,
                                             lambda a, n: denoise_batch(a, n, cfg), (device,),
                                             "denoise_batch"):
        with span("denoise_clips.unpad"):
            for j, i in enumerate(chunk):
                out[i] = cleaned[j, : lens[j]]
    return out  # type: ignore[return-value]
