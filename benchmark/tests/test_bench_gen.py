"""The traffic is deterministic by seed and within its bounds."""

import io
import wave

import numpy as np

import gen

LENGTHS = {"median_s": 2.07, "sigma": 0.536, "min_s": 0.45, "max_s": 10.09, "shape_seed": 20260}


def test_lengths_deterministic_and_bounded():
    a = gen.lengths_s(905, LENGTHS)
    assert np.array_equal(a, gen.lengths_s(905, LENGTHS))  # every seed's work is the same
    assert not np.array_equal(a, gen.lengths_s(905, LENGTHS, 10**8))  # a warm-up's is other
    assert a.min() >= 0.45 and a.max() <= 10.09
    # the lognormal's median survives the truncation closely
    assert abs(np.median(a) - 2.07) < 0.15


def test_poisson_schedule_exact_rate_and_fixed_across_seeds():
    t = gen.arrivals_s(76.0, 45.0, 11)
    assert len(t) == round(76 * 45)
    assert t[0] == 0.0 and np.all(np.diff(t) > 0) and t[-1] < 45.0
    assert np.array_equal(t, gen.arrivals_s(76.0, 45.0, 11))
    gaps = np.diff(t)
    # exponential gaps: the coefficient of variation is about 1
    assert 0.9 < gaps.std() / gaps.mean() < 1.1


def test_clips_deterministic_by_seed_and_index():
    a = gen.recording_clip(123456789012, 3, 16000, 16000)
    assert a.dtype == np.float32 and a.shape == (16000,)
    assert np.array_equal(a, gen.recording_clip(123456789012, 3, 16000, 16000))
    assert not np.array_equal(a, gen.recording_clip(123456789012, 4, 16000, 16000))
    assert np.isfinite(a).all() and np.abs(a).max() > 0.01


def test_upload_is_pcm16_wav_at_its_rate_and_peak():
    body = gen.upload(9, 0, 1.5, 22050, 0.5)
    with wave.open(io.BytesIO(body)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 22050)
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert len(pcm) == int(1.5 * 22050)
    assert abs(np.abs(pcm).max() / 32768 - 0.5) < 1e-4


def test_sample_draws_from_the_seed_and_keeps_the_always():
    s = gen.sample(100, 8, 42, always=[97])
    assert len(s) == 8 == len(set(s)) and 97 in s
    assert s == gen.sample(100, 8, 42, always=[97])
    assert s != gen.sample(100, 8, 43, always=[97])


TABLE = {"rows": 905, "features": 149, "classes": 3, "separation": 0.15, "shape_seed": 20262}


def test_feature_rows_deterministic_scaled_and_class_dependent():
    x, y = gen.feature_rows(2**31 + 5, TABLE)
    assert x.shape == (905, 149) and x.dtype == np.float32 and y.dtype == np.int64
    x2, y2 = gen.feature_rows(2**31 + 5, TABLE)
    assert np.array_equal(x, x2) and np.array_equal(y, y2)
    x3, y3 = gen.feature_rows(7, TABLE)
    assert np.array_equal(y, y3) and not np.array_equal(x, x3)  # labels from the shape seed
    assert np.bincount(y).tolist() == [302, 302, 301]
    assert np.allclose(x.mean(0), 0, atol=1e-5) and np.allclose(x.std(0), 1, atol=1e-4)
    means = np.stack([x[y == c].mean(0) for c in range(3)])
    assert np.abs(means[0] - means[1]).mean() > 0.05  # the classes lie apart


def test_folds_stratified_and_fixed_by_the_shape_seed():
    _, y = gen.feature_rows(1, TABLE)
    f = gen.folds(y, 5, 20262)
    test = np.concatenate([te for _, te in f])
    assert np.array_equal(np.sort(test), np.arange(905))  # every row held out once
    for tr, te in f:
        assert len(np.intersect1d(tr, te)) == 0 and len(tr) + len(te) == 905
        assert np.bincount(y[te]).min() >= 60  # each class in each fold
    assert max(len(tr) for tr, _ in f) == 725  # 725 // 128 = 5 steps an epoch
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(f, gen.folds(y, 5, 20262)))
