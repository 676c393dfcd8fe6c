"""The port's 149-dim features and its denoise held directly against the
NumPy oracle (stutter_tpu/oracle), at the bounds the JAX package's own
tests use for it: per-clip mean absolute feature error < 1e-4
(tests/test_jax_frontend.py), denoised output within 0.03 with correlation
> 0.9999 (tests/test_denoise.py)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def test_149_features_match_the_oracle_per_clip():
    from stutter_tpu.oracle import frontend as OF
    from stutter_tpu_torch.config import FEATURES_149
    from stutter_tpu_torch.ops.frontend import extract_features_numpy

    rng = np.random.RandomState(51)
    t = np.arange(24576) / 16000
    clips = [(rng.randn(n) * 0.2).astype(np.float32) for n in (7200, 16000, 24000)]
    clips.append((0.4 * np.sin(2 * np.pi * 523.25 * t) + 0.02 * rng.randn(24576))
                 .astype(np.float32))  # tonal: the chroma block carries it
    feats = extract_features_numpy(clips, FEATURES_149, device="cpu")
    for y, f in zip(clips, feats):
        ref = OF.extract_features(y, 16000, variant=149)
        assert np.abs(f - ref).mean() < 1e-4


@pytest.mark.parametrize("prop", [1.0, 0.8])
def test_denoise_matches_the_oracle(prop):
    from stutter_tpu.config import DenoiseConfig as JDenoiseConfig
    from stutter_tpu.oracle.denoise import denoise_clip
    from stutter_tpu_torch.config import DenoiseConfig
    from stutter_tpu_torch.denoise import denoise_clips

    rng = np.random.RandomState(52)
    t = np.arange(20000) / 16000
    y = (0.3 * np.sin(2 * np.pi * 500 * t) + rng.randn(20000) * 0.05).astype(np.float32)
    ours = denoise_clips([y], DenoiseConfig(prop_decrease=prop), device="cpu")[0]
    ref = denoise_clip(y, JDenoiseConfig(prop_decrease=prop))
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() < 0.03
    assert np.corrcoef(ours, ref)[0, 1] > 0.9999
