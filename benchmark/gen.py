"""The one general traffic generator: every mix file's parameters go
through these functions, so a new mix is a new data file.

Everything but the shape of the work is drawn from the run's seed: the
clip lengths and the arrival schedule come from the mix's own
`shape_seed` alone, so every seed offers the same work in the same order
(which requests burst together decides a tail); the content of each clip
comes from the run's seed.
Seeds may be any non-negative whole number (numpy's SeedSequence takes
them unbounded).
"""

from __future__ import annotations

import io
import math
import wave

import numpy as np


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng([int(k) for k in key])


def lengths_s(n: int, lengths: dict, offset: int = 0) -> np.ndarray:
    """n clip durations (seconds): a lognormal with `median_s` and `sigma`,
    truncated to [`min_s`, `max_s`] by redrawing, drawn from the mix's
    `shape_seed` (plus `offset`, for a second stream such as a warm-up)."""
    rng = _rng(lengths["shape_seed"] + offset, n)
    out = np.empty(0)
    while out.size < n:
        d = rng.lognormal(math.log(lengths["median_s"]), lengths["sigma"], 2 * n)
        out = np.concatenate([out, d[(d >= lengths["min_s"]) & (d <= lengths["max_s"])]])
    return out[:n]


def arrivals_s(rate: float, seconds: float, shape_seed: int) -> np.ndarray:
    """Poisson arrivals at `rate` a second over [0, seconds): round(rate x
    seconds) exponential gaps from `shape_seed` alone, scaled so that they
    sum to `seconds` (the offered rate is exact); the first request is due
    at 0."""
    n = max(int(round(rate * seconds)), 1)
    gaps = _rng(shape_seed, n, 2).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def recording_clip(seed: int, i: int, n: int, sr: int) -> np.ndarray:
    """Clip i of a run: a recording-like signal of n samples -- a noise
    floor that never stops and one to three partials, gated on and off in
    a third of the clips (the shape of chip_smoke.corpus_clip, drawn from
    (seed, i) alone so that any clip can be made again on its own)."""
    rng = _rng(seed, i, 4)
    t = np.arange(n) / sr
    y = rng.standard_normal(n) * rng.uniform(0.005, 0.05)
    tones = np.zeros(n)
    for _ in range(int(rng.integers(1, 4))):
        tones += rng.uniform(0.1, 0.5) * np.sin(2 * np.pi * rng.uniform(80, 3500) * t
                                                 + rng.uniform(0, 2 * np.pi))
    if rng.integers(3) == 0:
        tones *= (t % rng.uniform(0.2, 0.6)) < 0.15
    return (y + tones).astype(np.float32)


def pcm16_wav(y: np.ndarray, sr: int) -> bytes:
    """A mono PCM16 WAV file in memory: samples scaled by 32768, rounded to
    nearest and clipped, as libsndfile writes them."""
    pcm = np.clip(np.rint(np.asarray(y, np.float64) * 32768.0), -32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def upload(seed: int, i: int, dur_s: float, sr: int, peak: float) -> bytes:
    """Request i's upload: clip i at `sr`, scaled to `peak`, as PCM16 WAV."""
    y = recording_clip(seed, i, max(int(dur_s * sr), 1), sr)
    return pcm16_wav(y * (peak / max(float(np.abs(y).max()), 1e-9)), sr)


def sample(n: int, k: int, seed: int, always=()) -> list[int]:
    """k distinct indices of range(n) drawn from `seed`, those in `always`
    among them (the longest request, for one)."""
    chosen = [int(i) for i in always][:k]
    rest = [int(i) for i in _rng(seed, n, 5).permutation(n) if int(i) not in chosen]
    return sorted(chosen + rest[: max(k - len(chosen), 0)])


def feature_rows(seed: int, table: dict) -> tuple[np.ndarray, np.ndarray]:
    """A labelled feature table as a corpus's cache holds it: `rows` x
    `features` float32 rows in `classes` classes, each class a Gaussian
    around its own mean (drawn `separation` apart on each feature, unit
    noise), standard-scaled per feature over all rows.  The labels come
    from `shape_seed` alone, so every seed trains the same folds; the
    means and the noise come from the run's seed."""
    n, d, c = table["rows"], table["features"], table["classes"]
    y = _rng(table["shape_seed"], n, 6).permutation(np.arange(n) % c)
    rng = _rng(seed, n, d, 7)
    means = rng.standard_normal((c, d)) * table["separation"]
    x = means[y] + rng.standard_normal((n, d))
    x = (x - x.mean(0)) / x.std(0)
    return x.astype(np.float32), y.astype(np.int64)


def folds(y: np.ndarray, k: int, shape_seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """k stratified folds, (train rows, test rows) each sorted: every
    class's rows, permuted from `shape_seed`, dealt to the folds in turn."""
    rng = _rng(shape_seed, len(y), 8)
    fold_of = np.empty(len(y), np.int64)
    for c in np.unique(y):
        rows = rng.permutation(np.flatnonzero(y == c))
        fold_of[rows] = np.arange(len(rows)) % k
    return [(np.flatnonzero(fold_of != f), np.flatnonzero(fold_of == f)) for f in range(k)]
