"""Audio decode to mono float32 at a target rate (counterpart of
stutter_tpu/io/decode.py, whose resampling imports JAX).

The decoder hooks are the JAX package's registry
(`stutter_tpu.io.decode.register_decoder`), so one registration serves both
packages; the port resamples with its own resampler on `device`.  Reading a
file and resampling it are two steps, so a caller that degrades on
undecodable files (`read_audio` raising) still sees a device error of the
resampler.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stutter_tpu.io.decode import Decoder, get_decoder
from stutter_tpu_torch.ops.resample import resample


def read_audio(path: str, sr: int, decoder: Decoder | None = None) -> tuple[np.ndarray, int]:
    """(mono float32 PCM, its rate) of `path`, in the JAX package's order: the
    explicit `decoder(path, sr)` (its output is at `sr`); the WAV reader; the
    hook registered for the file's extension (at `sr`); libmpg123 for `.mp3`
    where that library exists.  Raises when nothing decodes the file."""
    if decoder is not None:
        return np.asarray(decoder(path, sr), np.float32), sr
    from stutter_tpu.io import mp3
    from stutter_tpu.io.wav import read_wav

    try:
        y, file_sr = read_wav(path)
        if y.ndim == 2:
            y = y.mean(axis=1)
    except Exception:
        hook = get_decoder(path)
        if hook is not None:
            return np.asarray(hook(path, sr), np.float32), sr
        if os.path.splitext(path)[1].lower() != ".mp3" or not mp3.available():
            raise
        y, file_sr = mp3.decode_mp3(path)
    return np.asarray(y, np.float32), file_sr


def to_rate(y: np.ndarray, file_sr: int, sr: int, device: torch.device | str = "cpu") -> np.ndarray:
    """`y` at `file_sr` resampled to `sr` on `device` (unchanged when equal)."""
    return y if file_sr == sr else resample(y, file_sr, sr, device=device)


def decode_audio(
    path: str, sr: int, decoder: Decoder | None = None, device: torch.device | str = "cpu"
) -> np.ndarray:
    """Decode `path` to mono float32 PCM at `sr` (`read_audio`, then the
    port's resampler on `device` when the rates differ)."""
    return to_rate(*read_audio(path, sr, decoder), sr, device)
