"""The port's 286-dim variant (ops/frontend334.py), its masked helpers and
the QC metrics (ops/qc.py) against the JAX package's functions and the NumPy
oracle on the CPU, where every op runs its plain PyTorch version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

N = 24576


def _batch():
    """Tonal, noise, gated tone, silent and under-9-frame clips, zero-padded."""
    rng = np.random.RandomState(31)
    t = np.arange(N) / 16000
    rows = [
        0.5 * np.sin(2 * np.pi * 220.7 * t) + 0.05 * rng.randn(N),
        0.3 * rng.randn(N),
        0.4 * np.sin(2 * np.pi * 452.2 * t) * (t % 0.3 < 0.2) + 0.02 * rng.randn(N),
        np.zeros(N),
        0.2 * rng.randn(N),
    ]
    audio = np.stack(rows).astype(np.float32)
    lengths = np.array([N, 20000, 15000, 6000, 2000], np.int32)
    for b, n in enumerate(lengths):
        audio[b, n:] = 0
    return audio, lengths


@pytest.fixture(scope="module")
def features():
    from stutter_tpu.ops.frontend334 import extract_features_334_batch as j_extract
    from stutter_tpu_torch.ops.frontend334 import extract_features_334_batch

    audio, lengths = _batch()
    ours = extract_features_334_batch(torch.from_numpy(audio), torch.from_numpy(lengths)).numpy()
    theirs = np.asarray(j_extract(jnp.asarray(audio), jnp.asarray(lengths)))
    return audio, lengths, ours, theirs


def test_334_batch_matches_jax(features):
    """MFCC/delta/chroma dims [:264] within 1e-3 absolute plus 2e-6 relative
    (the silent clip's MFCC 0 is -1131 dB, where f32 sums in another order
    differ by ~1e-3); contrast per band within 1e-3 dB (both sort the same
    magnitudes, which differ by f32 rounding of the power only); zcr and rms
    within 1e-6, the centroid (Hz) within 1e-6 relative."""
    _, _, ours, theirs = features
    assert ours.shape == theirs.shape == (5, 286)
    np.testing.assert_allclose(ours[:, :264], theirs[:, :264], rtol=2e-6, atol=1e-3)
    for band in range(14):  # 7 band means, then 7 band stds
        assert np.abs(ours[:, 264 + band] - theirs[:, 264 + band]).max() < 1e-3, band
    np.testing.assert_allclose(ours[:, 278:280], theirs[:, 278:280], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours[:, 280], theirs[:, 280], rtol=1e-6, atol=0)
    assert (ours[:, 281:] == 0).all()
    assert (ours[4] == 0).all()  # under 9 frames: all zero, as the reference's exception path


def test_334_batch_matches_oracle(features):
    """Per clip against oracle.frontend.extract_features(variant=334) on the
    unpadded clip: dims [:264] within 1e-3 (atol) + 2e-6 (rtol), contrast
    within 1e-3 dB, the scalars within 1e-3 (atol) + 1e-6 (rtol)."""
    from stutter_tpu.oracle import frontend as OF

    audio, lengths, ours, _ = features
    for b in range(4):  # the oracle cannot take a clip under 9 frames
        ref = OF.extract_features(audio[b, : lengths[b]], 16000, variant=334)
        np.testing.assert_allclose(ours[b, :264], ref[:264], rtol=2e-6, atol=1e-3)
        assert np.abs(ours[b, 264:278] - ref[264:278]).max() < 1e-3
        np.testing.assert_allclose(ours[b, 278:], ref[278:], rtol=1e-6, atol=1e-3)


def test_contrast_zcr_rms_and_masked_mean_match_jax():
    from stutter_tpu.ops import frontend334 as J
    from stutter_tpu.ops.masked import masked_mean as j_masked_mean
    from stutter_tpu_torch.ops import frontend334 as P
    from stutter_tpu_torch.ops.masked import masked_mean

    audio, lengths = _batch()
    a, le = torch.from_numpy(audio), torch.from_numpy(lengths)
    ja, jle = jnp.asarray(audio), jnp.asarray(lengths)
    for sr, n_fft in ((16000, 512), (16000, 2048)):
        assert P._contrast_bands(sr, n_fft, 200.0, 6) == J._contrast_bands(sr, n_fft, 200.0, 6)

    mag = np.abs(np.random.RandomState(32).randn(5, 97, 257)).astype(np.float32) + 1e-3
    ours = P.spectral_contrast_batch(torch.from_numpy(mag), 16000, 512).numpy()
    theirs = np.asarray(J.spectral_contrast_batch(jnp.asarray(mag), 16000, 512))
    assert ours.shape == theirs.shape == (5, 97, 7)
    for band in range(7):  # same magnitudes: only the log10 may round apart
        assert np.abs(ours[..., band] - theirs[..., band]).max() < 1e-5, band

    # zcr: the edge padding reaches each clip's last sample; the crossing
    # counts are equal, so the rates differ only by the rounding of the mean
    # (1e-7, far under one crossing in 2047)
    z = P.zcr_batch(a, le, 2048, 256).numpy()
    assert z.shape == (5, 1 + N // 256)
    np.testing.assert_allclose(z, np.asarray(J.zcr_batch(ja, jle, 2048, 256)), rtol=0, atol=1e-7)
    r = P.rms_batch(a, 2048, 256).numpy()
    np.testing.assert_allclose(r, np.asarray(J.rms_batch(ja, 2048, 256)), rtol=1e-5, atol=1e-7)

    x = np.random.RandomState(33).randn(5, 97, 3).astype(np.float32)
    mask = np.arange(97)[None, :] < np.array([97, 50, 1, 0, 9])[:, None]
    np.testing.assert_allclose(
        masked_mean(torch.from_numpy(x), torch.from_numpy(mask), axis=1).numpy(),
        np.asarray(j_masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=1)),
        rtol=1e-6, atol=1e-7)


def test_qc_metrics_match_jax():
    """SNR (dB) within 1e-4, the hf ratio within 1e-6 and flatness within
    2e-5 relative (the silent clip's exp(mean(log 1e-10)) / 1e-10 rounds
    apart by ~8e-6), per clip, including the silent and the
    shorter-than-one-SNR-frame cases."""
    from stutter_tpu.ops.qc import qc_metrics_batch as j_qc
    from stutter_tpu_torch.ops.qc import qc_metrics_batch

    audio, lengths = _batch()
    lengths = lengths.copy()
    lengths[4] = 300  # under one 25 ms frame: SNR 0.0
    audio[4, 300:] = 0
    ours = qc_metrics_batch(torch.from_numpy(audio), torch.from_numpy(lengths))
    theirs = j_qc(jnp.asarray(audio), jnp.asarray(lengths))
    assert set(ours) == set(theirs) == {"snr_db", "spectral_flatness", "hf_energy_ratio"}
    np.testing.assert_allclose(ours["snr_db"].numpy(), np.asarray(theirs["snr_db"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours["hf_energy_ratio"].numpy(),
                               np.asarray(theirs["hf_energy_ratio"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours["spectral_flatness"].numpy(),
                               np.asarray(theirs["spectral_flatness"]), rtol=2e-5, atol=0)
    assert ours["snr_db"][4] == 0.0 and ours["snr_db"][3] == 0.0
