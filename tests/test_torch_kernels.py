"""The plain PyTorch versions of the three kernels against the JAX package's
Pallas kernels (interpret mode) and XLA compositions, on the CPU, within the
bounds the JAX package holds its own kernels to (tests/test_pallas.py,
tests/test_denoise.py).  On a CPU tensor each wrapper runs its plain
version and launches nothing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stutter_tpu import config as jconfig
from stutter_tpu_torch.config import DenoiseConfig

torch.set_num_threads(2)


def _structured(rng, n=24576):
    t = np.arange(n) / 16000.0
    rows = [
        0.5 * np.sin(2 * np.pi * 220.7 * t) + 0.05 * rng.randn(n),
        0.3 * rng.randn(n),
        0.4 * np.sin(2 * np.pi * 452.2 * t) + 0.3 * np.sin(2 * np.pi * 1337.9 * t),
        np.zeros(n),
    ]
    return np.stack(rows).astype(np.float32), np.array([n, 20000, 9000, 6000], np.int32)


@pytest.fixture(scope="module")
def spectromel_case():
    from stutter_tpu.ops.pallas_spectromel import spectromel_pallas
    from stutter_tpu_torch.ops.spectromel import spectromel

    audio, lengths = _structured(np.random.RandomState(11))
    before = spectromel.launches
    ours = [x.numpy() for x in spectromel(torch.from_numpy(audio), torch.from_numpy(lengths))]
    assert spectromel.launches == before  # CPU tensors never launch the kernel
    pallas = [np.asarray(x) for x in spectromel_pallas(
        jnp.asarray(audio), jnp.asarray(lengths), with_tuning=True, with_stats=True,
        interpret=True)]
    return audio, lengths, ours, pallas


def test_spectromel_plain_matches_pallas_kernel(spectromel_case):
    _, _, (p, stats, tb), (p_k, stats_k, tb_k) = spectromel_case
    assert p.shape == p_k.shape == (4, 49, 1025) and stats.shape == (4, 6, 20)
    assert np.abs(p - p_k).max() / p_k.max() < 1e-5
    assert np.abs(stats - stats_k).max() < 2e-3
    assert np.abs(stats - stats_k).mean() < 2e-4
    np.testing.assert_array_equal(tb, tb_k)
    assert tb[3] == 50


def test_spectromel_plain_matches_xla_composition(spectromel_case):
    from stutter_tpu.ops.chroma import estimate_tuning_bin
    from stutter_tpu.ops.delta import sg_deltas
    from stutter_tpu.ops.masked import frame_mask, masked_mean_std
    from stutter_tpu.ops.spectral import mel_power_to_db, mfcc_from_db, power_spectrogram

    audio, lengths, (p, stats, tb), _ = spectromel_case
    a, le = jnp.asarray(audio), jnp.asarray(lengths)
    power = power_spectrogram(a, 2048, 512, method="fft")
    mask = frame_mask(le, 512, power.shape[1])
    power = jnp.where(mask[:, :, None], power, 0.0)
    mf = mfcc_from_db(mel_power_to_db(power, mask, 16000, 2048, 128), 20)
    d1, d2 = sg_deltas(mf, 1 + le // 512)
    ref = np.stack([np.asarray(r) for x in (mf, d1, d2)
                    for r in masked_mean_std(x, mask, axis=1)], axis=1)
    assert np.abs(p - np.asarray(power)).max() / float(power.max()) < 1e-5
    assert np.abs(stats - ref).max() < 2e-3
    assert np.abs(stats - ref).mean() < 2e-4
    np.testing.assert_array_equal(tb, np.asarray(estimate_tuning_bin(power, 16000, 2048)))


def test_chroma_stats_plain_matches_pallas_kernel(spectromel_case):
    from stutter_tpu.ops.pallas_chroma import chroma_stats_pallas
    from stutter_tpu_torch.ops.chroma_stats import chroma_stats

    _, lengths, (p, _, _), _ = spectromel_case
    n_valid = 1 + lengths // 512
    # both table extremes, the no-candidate bin and one more
    tb = np.array([0, 50, 99, 23], np.int32)
    before = chroma_stats.launches
    ours = chroma_stats(torch.from_numpy(p), torch.from_numpy(tb), torch.from_numpy(n_valid))
    assert chroma_stats.launches == before
    theirs = np.asarray(chroma_stats_pallas(jnp.asarray(p), jnp.asarray(tb),
                                            jnp.asarray(n_valid), interpret=True))
    assert ours.shape == (4, 24)
    assert np.abs(ours.numpy() - theirs).max() < 1e-5


def _gate_inputs(rng, N=4096):
    t = np.arange(N) / 16000
    clean = 0.5 * np.sin(2 * np.pi * 440 * t) * (t % 0.25 < 0.125)
    audio = np.stack([
        (clean + rng.randn(N) * 0.05).astype(np.float32),
        (rng.randn(N) * 0.2).astype(np.float32),
    ])
    return audio, np.asarray([N, 3000], np.int32)


@pytest.mark.parametrize("prop", [1.0, 0.8])
def test_gate_plain_matches_jax_gate_and_kernel(prop):
    """denoise_batch (plain gate on CPU) == the JAX XLA gate and the Pallas
    gate (interpret mode), at the shapes of test_denoise.py."""
    from stutter_tpu.denoise import denoise_batch as j_denoise
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate

    cfg = DenoiseConfig(prop_decrease=prop)
    audio, lengths = _gate_inputs(np.random.RandomState(12))
    before = spectral_gate.launches
    ours = denoise_batch(torch.from_numpy(audio), torch.from_numpy(lengths), cfg).numpy()
    assert spectral_gate.launches == before
    for pallas in (False, True):
        ref = np.asarray(j_denoise(jnp.asarray(audio), jnp.asarray(lengths),
                                   jconfig.DenoiseConfig(prop_decrease=prop),
                                   pallas=pallas, interpret=pallas))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-5)
    assert np.abs(ours[1, 3000:]).max() == 0.0  # trailing padding stays exactly 0


def test_gate_batch_equals_single_and_zero_stays_zero():
    from stutter_tpu_torch.denoise import denoise_clips

    rng = np.random.RandomState(13)
    t = np.arange(24576) / 16000
    clips = [
        (0.5 * np.sin(2 * np.pi * 300 * t[:20000]) + rng.randn(20000) * 0.1).astype(np.float32),
        (0.5 * np.sin(2 * np.pi * 800 * t) + rng.randn(24576) * 0.02).astype(np.float32),
        np.zeros(24576, np.float32),
    ]
    batched = denoise_clips(clips, device="cpu")
    for c, b in zip(clips, batched):
        np.testing.assert_allclose(b, denoise_clips([c], device="cpu")[0], rtol=0, atol=1e-6)
    assert np.isfinite(batched[2]).all() and (batched[2] == 0.0).all()


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (512, 256)])
def test_spectromel_mel_mode_plain_matches_pallas_kernel(n_fft, hop):
    """The mel-output mode (with_stats=False; the 286-dim variant runs it at
    n_fft 512, hop 256) against spectromel_pallas(with_tuning=True,
    with_stats=False) in interpret mode, within tests/test_pallas.py's
    bounds: power relative 1e-5, mel relative 1e-4, tuning bin exact."""
    from stutter_tpu.ops.pallas_spectromel import spectromel_pallas
    from stutter_tpu_torch.ops.spectromel import spectromel

    audio, lengths = _structured(np.random.RandomState(14))
    before = (spectromel.launches, spectromel.mel_launches)
    p, m, tb = (x.numpy() for x in spectromel(
        torch.from_numpy(audio), torch.from_numpy(lengths), n_fft=n_fft, hop_length=hop,
        with_stats=False))
    assert (spectromel.launches, spectromel.mel_launches) == before
    p_k, m_k, tb_k = (np.asarray(x) for x in spectromel_pallas(
        jnp.asarray(audio), jnp.asarray(lengths), n_fft=n_fft, hop_length=hop,
        with_tuning=True, with_stats=False, interpret=True))
    T = 24576 // hop + 1
    assert p.shape == p_k.shape == (4, T, n_fft // 2 + 1) and m.shape == (4, T, 128)
    assert np.abs(p - p_k).max() / p_k.max() < 1e-5
    assert np.abs(m - m_k).max() / m_k.max() < 1e-4
    np.testing.assert_array_equal(tb, tb_k)
    assert tb[3] == 50
    # frames past each clip's end are exactly zero in both outputs
    n_valid = 1 + lengths // hop
    for b in range(4):
        assert not p[b, n_valid[b]:].any() and not m[b, n_valid[b]:].any()
