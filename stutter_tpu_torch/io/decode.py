"""Audio decode at the file's own rate -> mono -> the port's resampler
(counterpart of stutter_tpu/io/decode.py, whose resampling imports JAX).

WAV goes through stutter_tpu.io.wav.read_wav; MPEG files through libmpg123
(stutter_tpu.io.mp3.decode_mp3) where that library exists.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stutter_tpu_torch.ops.resample import resample


def decode_audio(path: str, sr: int, device: torch.device | str = "cpu") -> np.ndarray:
    """Decode `path` to mono float32 PCM at `sr`."""
    if os.path.splitext(path)[1].lower() == ".mp3":
        from stutter_tpu.io.mp3 import decode_mp3

        y, file_sr = decode_mp3(path)
    else:
        from stutter_tpu.io.wav import read_wav

        y, file_sr = read_wav(path)
        if y.ndim == 2:
            y = y.mean(axis=1)
    if file_sr != sr:
        y = resample(y, file_sr, sr, device=device)
    return np.asarray(y, np.float32)
