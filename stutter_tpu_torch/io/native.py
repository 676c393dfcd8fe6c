"""Batched corpus loading with prefetch (counterpart of stutter_tpu/io/native.py).

`load_wav_batch` decodes a batch of files into a padded [B, n_max] buffer
with the port's multithreaded C++ WAV loader (native/stutter_io.cpp, built
with g++ at first use into stutter_tpu_torch/_build/, keyed by a hash of
the source).  Rows it rejects (other rates, other formats) go through the
port's `read_audio` and resampler, so off-rate WAVs are resampled on the
device and hooks registered for other formats apply.  `BatchPrefetcher`
decodes one batch ahead on a background thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import queue
import subprocess
import tempfile
import threading
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.io.decode import read_audio, to_rate

_SRC = Path(__file__).resolve().parent.parent / "native" / "stutter_io.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

log = logging.getLogger("stutter_tpu_torch.io.native")


def library_path() -> Path:
    """Where the loader builds to: its name plus a hash of source and flags."""
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD_DIR / f"libstutter_io-{h.hexdigest()[:16]}.so"


@lru_cache(maxsize=None)
def _build_and_load() -> ctypes.CDLL | None:
    """The C++ loader, built with g++ on first use; None (and every row
    through the Python reader) where no compiler is available."""
    so = library_path()
    try:
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", *_GXX_FLAGS, str(_SRC), "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError) as e:
        log.warning("C++ WAV loader unavailable (%s); decoding in Python", e)
        return None
    lib.st_abi_version.restype = ctypes.c_int
    if lib.st_abi_version() != 1:
        raise RuntimeError(f"{so}: unexpected ABI version {lib.st_abi_version()}")
    lib.st_load_wav_batch.restype = ctypes.c_int
    lib.st_load_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.c_int,
    ]
    return lib


def load_wav_batch(
    paths: list[str],
    n_samples_max: int,
    sr: int = 16000,
    n_threads: int = 8,
    decoder=None,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch into (audio [B, n_max] f32 zero-padded, lengths [B]).

    Rows that no decoder reads are zeros with length 0 (the reference's
    degrade-don't-crash loader, pipeline1.py:100-106); an error of the
    resampler on `device` propagates."""
    device = resolve_device(device)
    B = len(paths)
    out = np.zeros((B, n_samples_max), np.float32)
    lengths = np.zeros(B, np.int32)
    lib = _build_and_load()
    if lib is not None and B:
        c_paths = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
        lib.st_load_wav_batch(c_paths, B, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              n_samples_max, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                              sr, n_threads)
    for i, p in enumerate(paths):
        if lengths[i]:
            continue
        try:
            y, file_sr = read_audio(p, sr, decoder)
        except Exception:  # noqa: BLE001 - an undecodable file degrades its row
            continue
        y = to_rate(y, file_sr, sr, device)
        n = min(len(y), n_samples_max)
        out[i, :n] = y[:n]
        lengths[i] = n
    return out, lengths


class BatchPrefetcher:
    """Double-buffered corpus iterator: decoding runs one batch ahead.

        for audio, lengths, paths in BatchPrefetcher(paths, bucket, 256): ...

    An error on the decoding thread is raised by the iteration."""

    def __init__(self, paths: list[str], n_samples_max: int, batch_size: int = 256,
                 sr: int = 16000, depth: int = 2, decoder=None,
                 device: torch.device | str = "cuda"):
        self.paths = paths
        self.n_samples_max = n_samples_max
        self.batch_size = batch_size
        self.sr = sr
        self.decoder = decoder
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._producer, daemon=True)

    def _producer(self):
        try:
            for s in range(0, len(self.paths), self.batch_size):
                chunk = self.paths[s : s + self.batch_size]
                audio, lengths = load_wav_batch(chunk, self.n_samples_max, self.sr,
                                                decoder=self.decoder, device=self.device)
                self._q.put((audio, lengths, chunk))
        except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
            self._q.put(e)
            return
        self._q.put(None)

    def __iter__(self):
        self._thread.start()
        while True:
            item = self._q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        self._thread.join()
