"""Plain PyTorch ops of the port against their JAX counterparts, on the same
numpy-seeded inputs (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)


def _clips(seed, n=24576):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    rows = [
        0.5 * np.sin(2 * np.pi * 220.7 * t) + 0.05 * rng.randn(n),
        0.3 * rng.randn(n),
        0.4 * np.sin(2 * np.pi * 452.2 * t) + 0.3 * np.sin(2 * np.pi * 1337.9 * t),
        np.zeros(n),
    ]
    return np.stack(rows).astype(np.float32), np.array([n, 20000, 9000, 3000], np.int32)


def _masked_power(audio, lengths):
    from stutter_tpu.ops.masked import frame_mask
    from stutter_tpu.ops.spectral import power_spectrogram

    p = np.asarray(power_spectrogram(jnp.asarray(audio), 2048, 512, method="fft"))
    mask = np.asarray(frame_mask(jnp.asarray(lengths), 512, p.shape[1]))
    return np.where(mask[:, :, None], p, 0.0).astype(np.float32), mask


def test_masked_median_equals_numpy():
    """Exact np.median, including ties, even counts and an empty row."""
    from stutter_tpu_torch.ops.masked import masked_median

    rng = np.random.RandomState(0)
    x = rng.randn(6, 40).astype(np.float32)
    x[1] = np.round(x[1] * 2) / 2  # many ties
    mask = rng.rand(6, 40) < 0.5
    mask[2] = False  # empty row
    mask[3] = True  # even count, all valid
    mask[4] = False
    mask[4, :7] = True  # odd count
    got = masked_median(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    for b in range(6):
        ref = np.float32(np.median(x[b][mask[b]])) if mask[b].any() else np.float32(0.0)
        assert got[b] == ref, (b, got[b], ref)


def test_masked_mean_std_matches_jax():
    from stutter_tpu.ops.masked import masked_mean_std as j_mms
    from stutter_tpu_torch.ops.masked import masked_mean_std

    rng = np.random.RandomState(1)
    x = rng.randn(3, 17, 5).astype(np.float32)
    mask = np.arange(17)[None, :] < np.array([17, 4, 0])[:, None]
    m, s = masked_mean_std(torch.from_numpy(x), torch.from_numpy(mask), axis=1)
    jm, js = j_mms(jnp.asarray(x), jnp.asarray(mask), axis=1)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


def test_power_spectrogram_and_mel_db_match_jax():
    from stutter_tpu.ops.spectral import mel_power_to_db as j_db
    from stutter_tpu.ops.spectral import mfcc_from_db as j_mfcc
    from stutter_tpu_torch.ops.masked import frame_mask
    from stutter_tpu_torch.ops.spectral import mel_power_to_db, mfcc_from_db, power_spectrogram

    audio, lengths = _clips(2)
    p_ref, mask = _masked_power(audio, lengths)
    p = power_spectrogram(torch.from_numpy(audio), 2048, 512)
    m = frame_mask(torch.from_numpy(lengths), 512, p.shape[1])
    assert (m.numpy() == mask).all()
    p = torch.where(m[:, :, None], p, 0.0)
    assert np.abs(p.numpy() - p_ref).max() / p_ref.max() < 1e-5

    # same power in: dB and MFCC agree to f32 rounding
    db = mel_power_to_db(torch.from_numpy(p_ref), m, 16000, 2048, 128)
    db_ref = np.asarray(j_db(jnp.asarray(p_ref), jnp.asarray(mask), 16000, 2048, 128))
    np.testing.assert_allclose(db.numpy(), db_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mfcc_from_db(db, 20).numpy(),
                               np.asarray(j_mfcc(jnp.asarray(db_ref), 20)), rtol=1e-5, atol=2e-4)


def test_sg_deltas_match_jax():
    from stutter_tpu.ops.delta import sg_deltas as j_sg
    from stutter_tpu_torch.ops.delta import sg_deltas

    rng = np.random.RandomState(3)
    x = (rng.randn(4, 49, 20) * 50).astype(np.float32)
    n_valid = np.array([49, 40, 9, 23], np.int32)
    ours = sg_deltas(torch.from_numpy(x), torch.from_numpy(n_valid))
    theirs = j_sg(jnp.asarray(x), jnp.asarray(n_valid))
    valid = np.arange(49)[None, :] < n_valid[:, None]
    for o, t in zip(ours, theirs):
        o, t = o.numpy()[valid], np.asarray(t)[valid]
        assert np.abs(o - t).max() <= 1e-5 * np.abs(t).max()


def test_chroma_from_power_matches_jax():
    from stutter_tpu.ops.chroma import chroma_from_power as j_chroma
    from stutter_tpu_torch.ops.chroma import chroma_from_power

    audio, lengths = _clips(4)
    p, _ = _masked_power(audio, lengths)
    tb = np.array([0, 50, 99, 37], np.int32)
    ours = chroma_from_power(torch.from_numpy(p), torch.from_numpy(tb), 16000, 2048).numpy()
    theirs = np.asarray(j_chroma(jnp.asarray(p), jnp.asarray(tb), 16000, 2048))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [5, 6])
def test_estimate_tuning_bin_exact_on_same_power(seed):
    from stutter_tpu.ops.chroma import estimate_tuning_bin as j_etb
    from stutter_tpu_torch.ops.chroma import (
        estimate_tuning_bin,
        piptrack_candidates,
        tuning_bin_from_candidates,
    )

    audio, lengths = _clips(seed)
    p, _ = _masked_power(audio, lengths)
    tb = estimate_tuning_bin(torch.from_numpy(p), 16000, 2048).numpy()
    np.testing.assert_array_equal(tb, np.asarray(j_etb(jnp.asarray(p), 16000, 2048)))
    assert tb[3] == 50  # silent clip: librosa's no-candidate fallback
    # the candidate layout does not change the answer
    mags, idxm = piptrack_candidates(torch.from_numpy(p), 16000, 2048)
    assert mags.shape == idxm.shape == (4, p.shape[1], 492)
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(492))
    np.testing.assert_array_equal(
        tuning_bin_from_candidates(mags[..., perm], idxm[..., perm]).numpy(), tb)


def test_resample_matches_jax():
    from stutter_tpu.ops.resample import resample as j_resample
    from stutter_tpu_torch.ops.resample import resample

    rng = np.random.RandomState(7)
    for sr_in, sr_out, n in ((22050, 16000, 9000), (8000, 16000, 3000), (24000, 16000, 500)):
        y = (rng.randn(n) * 0.3).astype(np.float32)
        ours = resample(y, sr_in, sr_out)
        theirs = np.asarray(j_resample(y, sr_in, sr_out))
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
