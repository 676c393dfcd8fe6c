"""Pure-NumPy WAV read/write (counterpart of stutter_tpu/io/wav.py).

RIFF/WAVE parsing written out, so the host path needs no C audio library.
Float conversion matches libsndfile/soundfile semantics (what librosa.load
sees): int16 -> float32 via x / 32768.0; writing float -> int16 rounds to
nearest and clips at [-32768, 32767], so a file written by either package
reads back the same from the other.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE
# ksmedia.h KSDATAFORMAT_SUBTYPE_* GUID tail (bytes 2..16 are shared; the
# leading two bytes carry the format tag)
_KSDATAFORMAT_SUFFIX = bytes.fromhex("000000001000800000aa00389b71")


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono-or-multichannel array, sample_rate).

    Returns shape (n,) for mono, (n, channels) otherwise. Supports PCM 8/16/24/32
    and IEEE float 32/64.
    """
    data = Path(path).read_bytes()
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")

    pos = 12
    fmt = None
    fmt_body = b""
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError(f"missing fmt/data chunk: {path}")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == _EXTENSIBLE:
        # The real format tag is the SubFormat GUID's first two bytes (GUID at
        # offset 24 of the fmt chunk); the GUID's 14-byte suffix must be the
        # canonical ksmedia base — reject unknown GUIDs rather than guessing
        # from bit depth (an extensible float32 WAV is NOT int32 PCM).
        if len(fmt_body) < 40:
            raise ValueError(f"extensible WAV without SubFormat GUID: {path}")
        (audio_format,) = struct.unpack_from("<H", fmt_body, 24)
        if fmt_body[26:40] != _KSDATAFORMAT_SUFFIX:
            raise ValueError(f"unknown WAVE_FORMAT_EXTENSIBLE SubFormat GUID: {path}")

    if audio_format == _PCM:
        if bits == 16:
            y = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            y = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            y = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            i32 = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            i32 = np.where(i32 >= 1 << 23, i32 - (1 << 24), i32)
            y = i32.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}: {path}")
    elif audio_format == _IEEE_FLOAT:
        dtype = "<f4" if bits == 32 else "<f8"
        y = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format tag {audio_format}: {path}")

    if channels > 1:
        y = y[: (len(y) // channels) * channels].reshape(-1, channels)
    return y, sample_rate


def load_mono(path: str | Path, sr: int | None = None) -> tuple[np.ndarray, int]:
    """Load a WAV as float32 mono, like librosa.load(mono=True) for WAV input.

    Multichannel audio is averaged across channels. If `sr` is given and does
    not match the file rate, the caller is expected to resample (see
    stutter_tpu_torch.ops.resample); this function raises to avoid silent
    drift.
    """
    y, file_sr = read_wav(path)
    if y.ndim == 2:
        y = y.mean(axis=1)
    if sr is not None and sr != file_sr:
        raise ValueError(
            f"{path}: sample rate {file_sr} != requested {sr}; resample explicitly"
        )
    return y, file_sr


def write_wav(path: str | Path, y: np.ndarray, sr: int, subtype: str = "PCM_16") -> None:
    """Write mono/multichannel float audio as WAV (PCM_16 or FLOAT).

    PCM_16 conversion matches libsndfile: scale by 32768, round-to-nearest,
    clip to int16 range (ref behavior at pipeline1.py:142 via sf.write).
    """
    y = np.asarray(y)
    if y.ndim == 1:
        channels = 1
    else:
        channels = y.shape[1]
    if subtype == "PCM_16":
        scaled = np.rint(y.astype(np.float64) * 32768.0)
        data = np.clip(scaled, -32768, 32767).astype("<i2").tobytes()
        bits, fmt_tag = 16, _PCM
    elif subtype == "FLOAT":
        data = y.astype("<f4").tobytes()
        bits, fmt_tag = 32, _IEEE_FLOAT
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    byte_rate = sr * channels * bits // 8
    block_align = channels * bits // 8
    header = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    header += b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_tag, channels, sr, byte_rate, block_align, bits
    )
    header += b"data" + struct.pack("<I", len(data))
    Path(path).write_bytes(header + data)
