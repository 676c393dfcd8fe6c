"""Batched corpus loading with prefetch (counterpart of stutter_tpu/io/native.py).

`load_wav_batch` decodes a batch of files into a padded [B, n_max] buffer
with the JAX package's multithreaded C++ WAV loader
(stutter_tpu/native/stutter_io.cpp, built with g++ at first use by
`stutter_tpu.io.native._build_and_load`).  Rows it rejects (other rates,
other formats) go through the port's `decode_audio`, so off-rate WAVs are
resampled by the port and hooks registered for other formats apply.  The
JAX package's own fallback is not used: it imports JAX's resampler.
`BatchPrefetcher` decodes one batch ahead on a background thread.
"""

from __future__ import annotations

import ctypes
import queue
import threading

import numpy as np
import torch

from stutter_tpu.io.native import _build_and_load
from stutter_tpu_torch.io.decode import read_audio, to_rate


def load_wav_batch(
    paths: list[str],
    n_samples_max: int,
    sr: int = 16000,
    n_threads: int = 8,
    decoder=None,
    device: torch.device | str = "cpu",
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch into (audio [B, n_max] f32 zero-padded, lengths [B]).

    Rows that no decoder reads are zeros with length 0 (the reference's
    degrade-don't-crash loader, pipeline1.py:100-106); an error of the
    resampler on `device` propagates."""
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
                 device: torch.device | str = "cpu"):
        self.paths = paths
        self.n_samples_max = n_samples_max
        self.batch_size = batch_size
        self.sr = sr
        self.decoder = decoder
        self.device = device
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
