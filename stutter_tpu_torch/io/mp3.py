"""MP3 decoding via the system libmpg123, bound with ctypes (counterpart of
stutter_tpu/io/mp3.py): `decode_mp3` is the raw decode, and `load_mp3`
resamples its output with the port's resampler on a torch device.

The reference ingests mp3 through librosa -> audioread/soundfile
(ref: pipeline1.py:100-106); its corpus is 905 MPEG-2 Layer III 22.05 kHz
mono files.  libmpg123, where the shared library exists, is driven over its
stable C ABI.  No mpg123 headers are installed, so the few ABI constants
used here are declared from the published mpg123.h values (stable across
the library's 1.x history).  Different MPEG decoders differ in dither,
rounding and leading delay, so raw-path features match the reference's only
approximately.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

# --- mpg123.h ABI constants (stable public API values) ---
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_MONO = 1
_MPG123_STEREO = 2
_MPG123_ADD_FLAGS = 2  # enum mpg123_parms
_MPG123_QUIET = 0x20  # enum mpg123_param_flags

_lock = threading.Lock()
_lib = None
_lib_err: str | None = None


def _load() -> ctypes.CDLL | None:
    """Load + one-time-init libmpg123; returns None (with reason recorded)
    where the library is absent so callers can degrade gracefully."""
    global _lib, _lib_err
    with _lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        try:
            lib = ctypes.CDLL("libmpg123.so.0")
        except OSError as e:
            _lib_err = str(e)
            return None
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        lib.mpg123_rates.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_long)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_param.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double,
        ]
        lib.mpg123_plain_strerror.restype = ctypes.c_char_p
        lib.mpg123_plain_strerror.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """True when libmpg123 can be loaded on this system."""
    return _load() is not None


def decode_mp3(path: str) -> tuple[np.ndarray, int]:
    """Decode an MPEG audio file -> (float32 mono PCM in [-1, 1], native sr).

    Stereo is downmixed by channel mean (librosa.load(mono=True) semantics).
    Raises RuntimeError on decode failure or if libmpg123 is unavailable.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"libmpg123 unavailable: {_lib_err}")

    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    try:
        lib.mpg123_param(h, _MPG123_ADD_FLAGS, _MPG123_QUIET, 0.0)
        # Constrain output to float32 at every native rate BEFORE open, so no
        # resampling/requantization happens inside the decoder.
        lib.mpg123_format_none(h)
        rates = ctypes.POINTER(ctypes.c_long)()
        n_rates = ctypes.c_size_t(0)
        lib.mpg123_rates(ctypes.byref(rates), ctypes.byref(n_rates))
        for i in range(n_rates.value):
            lib.mpg123_format(
                h, rates[i], _MPG123_MONO | _MPG123_STEREO, _MPG123_ENC_FLOAT_32
            )
        rc = lib.mpg123_open(h, str(path).encode())
        if rc != _MPG123_OK:
            raise RuntimeError(
                f"mpg123_open({path}): "
                f"{lib.mpg123_plain_strerror(rc).decode(errors='replace')}"
            )
        try:
            rate = ctypes.c_long(0)
            channels = ctypes.c_int(0)
            encoding = ctypes.c_int(0)
            rc = lib.mpg123_getformat(
                h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)
            )
            if rc != _MPG123_OK or encoding.value != _MPG123_ENC_FLOAT_32:
                raise RuntimeError(
                    f"mpg123_getformat({path}) rc={rc} enc={encoding.value}"
                )
            buf = (ctypes.c_char * (1 << 16))()
            done = ctypes.c_size_t(0)
            chunks: list[bytes] = []
            while True:
                rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
                if done.value:
                    chunks.append(bytes(buf[: done.value]))
                if rc == _MPG123_DONE:
                    break
                if rc == _MPG123_NEW_FORMAT:
                    # mid-stream format change: re-query so a rate/channel
                    # switch can't be de-interleaved with stale values —
                    # refuse rather than silently corrupt (the format list
                    # passed to mpg123_format above pins float32, so only
                    # rate/channels can legally change here)
                    r2, c2, e2 = ctypes.c_long(0), ctypes.c_int(0), ctypes.c_int(0)
                    lib.mpg123_getformat(
                        h, ctypes.byref(r2), ctypes.byref(c2), ctypes.byref(e2)
                    )
                    if (r2.value, c2.value) != (rate.value, channels.value):
                        raise RuntimeError(
                            f"mpg123_read({path}): mid-stream format change "
                            f"{rate.value}Hz/{channels.value}ch -> "
                            f"{r2.value}Hz/{c2.value}ch is unsupported"
                        )
                    continue
                if rc in (_MPG123_OK, _MPG123_NEED_MORE):
                    if rc == _MPG123_NEED_MORE and not done.value:
                        break  # truncated file: keep what we decoded
                    continue
                raise RuntimeError(
                    f"mpg123_read({path}): "
                    f"{lib.mpg123_plain_strerror(rc).decode(errors='replace')}"
                )
            pcm = np.frombuffer(b"".join(chunks), dtype=np.float32)
            if channels.value > 1:
                pcm = pcm.reshape(-1, channels.value).mean(axis=1)
            return np.ascontiguousarray(pcm, np.float32), int(rate.value)
        finally:
            lib.mpg123_close(h)
    finally:
        lib.mpg123_delete(h)


def load_mp3(
    path: str, sr: int | None = None, device: torch.device | str = "cuda"
) -> tuple[np.ndarray, int]:
    """Decode, then resample to `sr` on `device` when it differs from the
    file's rate (`io.decode.to_rate`): the librosa.load(path, sr=...,
    mono=True) shape of the reference's loader (ref: pipeline1.py:100-106).
    `sr=None` keeps the file's rate."""
    from stutter_tpu_torch.io.decode import to_rate

    y, native_sr = decode_mp3(path)
    if sr is None:
        return y, native_sr
    return np.asarray(to_rate(y, native_sr, sr, device), np.float32), sr
