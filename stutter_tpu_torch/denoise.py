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
from stutter_tpu_torch.ops.frontend import (DEFAULT_BUCKETS, STAGES, count_batch, pad_batch,
                                            pad_to_bucket)
from stutter_tpu_torch.ops.spectral_gate import spectral_gate
from stutter_tpu_torch.utils.profiling import span, tracing

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
    """Host wrapper: denoise a list of 1-D clips, grouped into sample buckets,
    on `device`.  Batches are padded into a stage of ops.frontend.STAGES,
    page-locked for a CUDA device.  Traced, the call is the span
    `denoise_clips` and each batch `denoise_clips.batch`, whose leaves are
    pad, h2d, `denoise_batch` (the launches), d2h and unpad
    (ops.frontend.count_batch counts it)."""
    device = resolve_device(device)
    out: list[np.ndarray | None] = [None] * len(clips)
    with span("denoise_clips"), STAGES.checkout(device.type == "cuda") as stage:
        by_bucket: dict[int, list[int]] = {}
        for i, y in enumerate(clips):
            by_bucket.setdefault(pad_to_bucket(len(y), DEFAULT_BUCKETS), []).append(i)
        for bucket, idxs in by_bucket.items():
            for s in range(0, len(idxs), batch_size):
                chunk = idxs[s : s + batch_size]
                with span("denoise_clips.batch"):
                    with span("denoise_clips.pad"):
                        batch, lens = pad_batch(clips, chunk, bucket, len(chunk), stage)
                    with span("denoise_clips.h2d"):
                        audio = batch.to(device)
                        lengths = torch.from_numpy(lens).to(device)
                    with span("denoise_batch"):
                        cleaned = denoise_batch(audio, lengths, cfg)
                    with span("denoise_clips.d2h"):
                        cleaned = cleaned.cpu().numpy()
                    with span("denoise_clips.unpad"):
                        for j, i in enumerate(chunk):
                            out[i] = cleaned[j, : lens[j]]
                    if tracing():
                        count_batch("denoise_clips", batch, lens, cleaned.nbytes)
    return out  # type: ignore[return-value]
