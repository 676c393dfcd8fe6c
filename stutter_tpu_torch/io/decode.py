"""Audio decode to mono float32 at a target rate, and the port's pluggable
decoder hooks (counterpart of stutter_tpu/io/decode.py).

The built-in readers take WAV (stutter_tpu_torch.io.wav, the C++ batch
loader) and, where libmpg123 exists, mp3.  Deployments that have another
codec register a hook, and every ingestion path of the port --
`extract_corpus`, `preprocess`, `Predictor.predict_file`, `load_wav_batch`
-- picks it up:

    from stutter_tpu_torch.io.decode import register_decoder

    def ffmpeg_decode(path: str, sr: int) -> np.ndarray:
        out = subprocess.run(
            ["ffmpeg", "-i", path, "-f", "f32le", "-ac", "1", "-ar", str(sr), "-"],
            capture_output=True, check=True).stdout
        return np.frombuffer(out, np.float32)

    register_decoder((".mp3", ".m4a", ".ogg"), ffmpeg_decode)

A decoder takes (path, target_sr) and returns mono float32 PCM at
target_sr.  This registry is the port's own: a hook registered here does
not serve the JAX package, and one registered with
`stutter_tpu.io.decode.register_decoder` does not serve the port.  A
per-call hook can also be passed explicitly (`decoder=`).

Reading a file and resampling it are two steps, so a caller that degrades
on undecodable files (`read_audio` raising) still sees a device error of
the resampler.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.ops.resample import resample

Decoder = Callable[[str, int], np.ndarray]

_REGISTRY: dict[str, Decoder] = {}


def register_decoder(exts: tuple[str, ...] | str, fn: Decoder) -> None:
    """Register `fn(path, sr) -> float32 PCM` for the given extensions."""
    if isinstance(exts, str):
        exts = (exts,)
    for e in exts:
        _REGISTRY[e.lower().lstrip(".")] = fn


def unregister_decoder(exts: tuple[str, ...] | str) -> None:
    if isinstance(exts, str):
        exts = (exts,)
    for e in exts:
        _REGISTRY.pop(e.lower().lstrip("."), None)


def get_decoder(path: str) -> Decoder | None:
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    return _REGISTRY.get(ext)


def read_audio(path: str, sr: int, decoder: Decoder | None = None) -> tuple[np.ndarray, int]:
    """(mono float32 PCM, its rate) of `path`, in the JAX package's order: the
    explicit `decoder(path, sr)` (its output is at `sr`); the WAV reader; the
    hook registered for the file's extension (at `sr`); libmpg123 for `.mp3`
    where that library exists.  Raises when nothing decodes the file."""
    if decoder is not None:
        return np.asarray(decoder(path, sr), np.float32), sr
    from stutter_tpu_torch.io import mp3
    from stutter_tpu_torch.io.wav import read_wav

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


def to_rate(y: np.ndarray, file_sr: int, sr: int, device: torch.device | str = "cuda") -> np.ndarray:
    """`y` at `file_sr` resampled to `sr` on `device` (unchanged when equal)."""
    device = resolve_device(device)
    return y if file_sr == sr else resample(y, file_sr, sr, device=device)


def decode_audio(
    path: str, sr: int, decoder: Decoder | None = None, device: torch.device | str = "cuda"
) -> np.ndarray:
    """Decode `path` to mono float32 PCM at `sr` (`read_audio`, then the
    port's resampler on `device` when the rates differ)."""
    device = resolve_device(device)
    return to_rate(*read_audio(path, sr, decoder), sr, device)
