"""The CUDA kernels against their plain PyTorch versions on the card, at
small shapes with edge cases (silent, short and odd-batch clips).  Marked
`gpu`: they skip without a CUDA device.  On a GPU machine without JAX run

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from stutter_tpu.config import DenoiseConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from stutter_tpu_torch.infer import resolve_device

    return resolve_device("cuda")


def _clips(seed, B, N):
    rng = np.random.RandomState(seed)
    t = np.arange(N) / 16000
    audio = (rng.randn(B, N) * 0.1).astype(np.float32)
    for b in range(B):
        audio[b] += 0.4 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t).astype(np.float32)
    audio[-1] = 0.0  # silent clip
    return audio


@pytest.mark.parametrize("N,lengths", [
    (24576, [24576, 20000, 4000, 3000, 9000]),  # incl. clips under 9 frames
    (163840, [163840, 150000, 60000]),  # the 10 s bucket
])
def test_spectromel_and_chroma_kernels_match_plain(cuda, N, lengths):
    from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
    from stutter_tpu_torch.ops.chroma_stats import chroma_stats, chroma_stats_plain
    from stutter_tpu_torch.ops.spectromel import spectromel, spectromel_plain

    audio = torch.from_numpy(_clips(1, len(lengths), N)).to(cuda)
    le = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lengths):
        audio[b, n:] = 0
    before = spectromel.launches
    p, st, tb = spectromel(audio, le)
    assert spectromel.launches == before + 1
    pp, stp, _ = spectromel_plain(audio, le)
    assert float((p - pp).abs().max() / pp.abs().max()) < 1e-5
    err = (st - stp).abs()
    assert float(err.max()) < 2e-3 and float(err.mean()) < 2e-4
    assert torch.equal(tb, estimate_tuning_bin(p, 16000, 2048))
    assert int(tb[-1]) == 50

    nv = 1 + le // 512
    tbs = torch.tensor([0, 99, 50, 7, 42][: len(lengths)], dtype=torch.int32, device=cuda)
    got = chroma_stats(p, tbs, nv)
    assert float((got - chroma_stats_plain(p, tbs, nv)).abs().max()) < 1e-5


@pytest.mark.parametrize("N,lengths", [
    (24576, [24576, 20000, 4000, 2000, 9000]),  # incl. clips under 9 frames
    (163840, [163840, 150000, 60000]),  # the 10 s bucket: 641 frames
])
def test_spectromel_mel_mode_matches_plain(cuda, N, lengths):
    """The mel-output mode at the 286-dim variant's geometry (n_fft 512, hop
    256, ratio 2): power relative 1e-5, mel relative 1e-4, the tuning bin
    equal to the plain estimate on the kernel's own power; silent clip ->
    bin 50.  The stats mode's count does not move."""
    from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
    from stutter_tpu_torch.ops.spectromel import spectromel, spectromel_plain

    audio = torch.from_numpy(_clips(3, len(lengths), N)).to(cuda)
    le = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lengths):
        audio[b, n:] = 0
    kw = dict(n_fft=512, hop_length=256, with_stats=False)
    before = (spectromel.launches, spectromel.mel_launches)
    p, m, tb = spectromel(audio, le, **kw)
    assert (spectromel.launches, spectromel.mel_launches) == (before[0], before[1] + 1)
    pp, mp, _ = spectromel_plain(audio, le, **kw)
    assert p.shape == (len(lengths), N // 256 + 1, 257) and m.shape[-1] == 128
    assert float((p - pp).abs().max() / pp.abs().max()) < 1e-5
    assert float((m - mp).abs().max() / mp.abs().max()) < 1e-4
    assert torch.equal(tb, estimate_tuning_bin(p, 16000, 512))
    assert int(tb[-1]) == 50
    n_valid = 1 + le // 256
    for b in range(len(lengths)):  # frames past the clip's end are exactly zero
        assert not p[b, n_valid[b]:].any() and not m[b, n_valid[b]:].any()


@pytest.mark.parametrize("prop", [1.0, 0.8])
def test_gate_kernel_matches_plain(cuda, prop):
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate_plain

    cfg = DenoiseConfig(prop_decrease=prop)
    audio = torch.from_numpy(_clips(2, 3, 4096)).to(cuda)
    le = torch.tensor([4096, 3000, 4096], dtype=torch.int32, device=cuda)
    got = denoise_batch(audio, le, cfg)
    ref = denoise_batch(audio, le, cfg, gate=spectral_gate_plain)
    assert float((got - ref).abs().max()) < 5e-5
    assert float(got[1, 3000:].abs().max()) == 0.0
    assert float(got[2].abs().max()) == 0.0  # silent in, silent out


def test_wrappers_reject_unsupported_geometry(cuda):
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate
    from stutter_tpu_torch.ops.spectromel import spectromel

    audio = torch.zeros(1, 24576, device=cuda)
    ones = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # ratio 3: neither mode
        spectromel(audio, ones, n_fft=768, hop_length=256)
    with pytest.raises(ValueError):
        spectromel(audio, ones, n_fft=768, hop_length=256, with_stats=False)
    with pytest.raises(ValueError):  # ratio 2 is the mel-output mode's only
        spectromel(audio, ones, n_fft=512, hop_length=256)
    with pytest.raises(ValueError):
        spectral_gate(torch.zeros(1, 10, 100, device=cuda), 400, 100, DenoiseConfig())
