"""The CUDA kernels against their plain PyTorch versions on the card, at
small shapes with edge cases (silent, short, ragged and odd-batch clips, a
single clip: the request shape).  Marked
`gpu`: they skip without a CUDA device.  On a GPU machine without JAX run

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from stutter_tpu_torch.config import DenoiseConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from stutter_tpu_torch.device import resolve_device

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
    (49152, [48000]),  # one 3 s request
    (49152, [49152, 47999, 30001, 17, 0]),  # ragged: not a multiple of hop, empty
])
def test_spectromel_and_chroma_kernels_match_plain(cuda, N, lengths):
    from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
    from stutter_tpu_torch.ops.chroma_stats import chroma_stats, chroma_stats_plain
    from stutter_tpu_torch.ops.spectromel import spectromel, spectromel_plain

    # one clip: the first of two (the last of _clips is silent)
    audio = torch.from_numpy(_clips(1, max(len(lengths), 2), N)[:len(lengths)]).to(cuda)
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
    if len(lengths) > 1:
        assert int(tb[-1]) == 50  # the silent clip

    nv = 1 + le // 512
    tbs = torch.tensor([0, 99, 50, 7, 42][: len(lengths)], dtype=torch.int32, device=cuda)
    got = chroma_stats(p, tbs, nv)
    assert float((got - chroma_stats_plain(p, tbs, nv)).abs().max()) < 1e-5


@pytest.mark.parametrize("N,lengths", [
    (24576, [24576, 20000, 4000, 2000, 9000]),  # incl. clips under 9 frames
    (163840, [163840, 150000, 60000]),  # the 10 s bucket: 641 frames
    (49152, [49152]),  # one 3 s request
    (49152, [48000, 33333, 255, 1, 40000]),  # ragged
])
def test_spectromel_mel_mode_matches_plain(cuda, N, lengths):
    """The mel-output mode at the 286-dim variant's geometry (n_fft 512, hop
    256, ratio 2): power relative 1e-5, mel relative 1e-4, the tuning bin
    equal to the plain estimate on the kernel's own power; silent clip ->
    bin 50.  The stats mode's count does not move."""
    from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
    from stutter_tpu_torch.ops.spectromel import spectromel, spectromel_plain

    # one clip: the first of two (the last of _clips is silent)
    audio = torch.from_numpy(_clips(3, max(len(lengths), 2), N)[:len(lengths)]).to(cuda)
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
    if len(lengths) > 1:
        assert int(tb[-1]) == 50  # the silent clip
    n_valid = 1 + le // 256
    for b in range(len(lengths)):  # frames past the clip's end are exactly zero
        assert not p[b, n_valid[b]:].any() and not m[b, n_valid[b]:].any()


@pytest.mark.parametrize("prop", [1.0, 0.8])
def test_gate_kernel_matches_plain(cuda, prop):
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate, spectral_gate_plain

    cfg = DenoiseConfig(prop_decrease=prop)
    audio = torch.from_numpy(_clips(2, 3, 4096)).to(cuda)
    le = torch.tensor([4096, 3000, 4096], dtype=torch.int32, device=cuda)
    before = spectral_gate.launches
    got = denoise_batch(audio, le, cfg)
    assert spectral_gate.launches == before + 1
    ref = denoise_batch(audio, le, cfg, gate=spectral_gate_plain)
    assert float((got - ref).abs().max()) < 5e-5
    assert float(got[1, 3000:].abs().max()) == 0.0
    assert float(got[2].abs().max()) == 0.0  # silent in, silent out


@pytest.mark.parametrize("B,N,lengths", [
    (1, 49152, [48000]),  # one 3 s request: the smallest tiles
    (3, 163840, [163840, 99999, 7]),  # ragged, at the 10 s bucket (879 chunks)
])
def test_gate_kernel_matches_plain_at_request_and_bucket_shapes(cuda, B, N, lengths):
    """Within the serving bound (0.03, correlation > 0.9999) and, on the
    gate's own output before the crop, 5e-5 relative to its peak on the
    rows where four frames overlap (the first and last three rows divide by
    a window-sum-square near 0, which denoise_batch crops away)."""
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate, spectral_gate_plain

    cfg = DenoiseConfig(prop_decrease=0.8)
    audio = torch.from_numpy(_clips(4, B + 1, N)[:B]).to(cuda)
    le = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lengths):
        audio[b, n:] = 0
    got = denoise_batch(audio, le, cfg)
    ref = denoise_batch(audio, le, cfg, gate=spectral_gate_plain)
    assert float((got - ref).abs().max()) < 0.03
    g, r = got - got.mean(1, keepdim=True), ref - ref.mean(1, keepdim=True)
    corr = (g * r).sum(1) / (g.norm(dim=1) * r.norm(dim=1) + 1e-12)
    assert float(corr[:2].min()) > 0.9999
    chunks = torch.nn.functional.pad(audio, (512, 512 + (-N) % 256)).reshape(B, -1, 256)
    k, p = spectral_gate(chunks, 1024, 256, cfg), spectral_gate_plain(chunks, 1024, 256, cfg)
    assert float((k - p)[:, 3:-3].abs().max() / p.abs().max()) < 5e-5


@pytest.mark.parametrize("n_fft,hop", [(1024, 128), (512, 64), (2048, 256)])
def test_spectromel_kernel_at_other_fft_sizes_and_ratios(cuda, n_fft, hop):
    """Both modes at the FFT sizes and n_fft / hop ratios the front ends do
    not use, within the same bounds."""
    from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
    from stutter_tpu_torch.ops.spectromel import spectromel, spectromel_plain

    lengths = [24576, 17001, 5000]
    audio = torch.from_numpy(_clips(5, 4, 24576)[:3]).to(cuda)
    le = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lengths):
        audio[b, n:] = 0
    kw = dict(n_fft=n_fft, hop_length=hop, n_mfcc=13)
    p, st, tb = spectromel(audio, le, **kw)
    pp, stp, _ = spectromel_plain(audio, le, **kw)
    assert float((p - pp).abs().max() / pp.abs().max()) < 1e-5
    err = (st - stp).abs()
    assert float(err.max()) < 2e-3 and float(err.mean()) < 2e-4
    assert torch.equal(tb, estimate_tuning_bin(p, 16000, n_fft))
    p, m, tb = spectromel(audio, le, with_stats=False, **kw)
    pp, mp, _ = spectromel_plain(audio, le, with_stats=False, **kw)
    assert float((m - mp).abs().max() / mp.abs().max()) < 1e-4
    assert torch.equal(tb, estimate_tuning_bin(p, 16000, n_fft))


@pytest.mark.parametrize("n_fft", [512, 2048])
def test_gate_kernel_at_other_fft_sizes(cuda, n_fft):
    """The gate at n_fft 512 and 2048 (hop n_fft / 4) against its plain
    version, at the test shapes' bound."""
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate_plain

    cfg = DenoiseConfig(n_fft=n_fft, hop_length=n_fft // 4, win_length=n_fft)
    audio = torch.from_numpy(_clips(6, 3, 8192)).to(cuda)
    le = torch.tensor([8192, 6000, 8192], dtype=torch.int32, device=cuda)
    got = denoise_batch(audio, le, cfg)
    ref = denoise_batch(audio, le, cfg, gate=spectral_gate_plain)
    assert float((got - ref).abs().max()) < 5e-5
    assert float(got[1, 6000:].abs().max()) == 0.0 and float(got[2].abs().max()) == 0.0


def test_wrappers_reject_unsupported_geometry(cuda):
    """The FFT kernels take n_fft 512, 1024 or 2048; spectromel any hop that
    divides the bucket, the gate n_fft == 4 hop only."""
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate
    from stutter_tpu_torch.ops.spectromel import spectromel

    audio = torch.zeros(1, 24576, device=cuda)
    ones = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # not a power of two
        spectromel(audio, ones, n_fft=768, hop_length=256)
    with pytest.raises(ValueError):
        spectromel(audio, ones, n_fft=768, hop_length=256, with_stats=False)
    with pytest.raises(ValueError):  # above the largest FFT
        spectromel(audio, ones, n_fft=4096, hop_length=1024)
    with pytest.raises(ValueError):  # hop does not divide N
        spectromel(audio, ones, n_fft=2048, hop_length=500, with_stats=False)
    with pytest.raises(ValueError):  # hop does not divide n_fft (the plain framing's rule)
        spectromel(audio, ones, n_fft=2048, hop_length=384, with_stats=False)
    # ratio 2 now runs in both modes
    assert spectromel(audio, ones, n_fft=512, hop_length=256)[1].shape == (1, 6, 20)
    with pytest.raises(ValueError):
        spectral_gate(torch.zeros(1, 10, 100, device=cuda), 400, 100, DenoiseConfig())
    with pytest.raises(ValueError):  # ratio 2
        spectral_gate(torch.zeros(1, 10, 512, device=cuda), 1024, 512, DenoiseConfig())


def _comb(N, n, n_fft, lo, hi):
    """Tones at every other FFT bin of [lo, hi), random phases: nearly every
    other bin of every frame is a piptrack candidate."""
    t = np.arange(N) / 16000
    ph = np.random.RandomState(8).uniform(0, 2 * np.pi, hi)
    y = sum(np.sin(2 * np.pi * k * 16000 / n_fft * t + ph[k]) for k in range(lo, hi, 2))
    y[n:] = 0
    return (0.05 * y).astype(np.float32)


@pytest.mark.parametrize("with_stats", [True, False])
def test_tuning_tail_over_capacity_matches_plain(cuda, with_stats):
    """A 10 s clip whose candidates (~77k at n_fft 2048) overflow a block's
    shared memory takes the tail's device-memory path; beside it a clip of
    tones in noise and a silent one.  Both modes: the tuning bin equals the
    plain estimate on the kernel's own power (the mel mode's comb, at
    n_fft 512, fits its shared memory)."""
    from stutter_tpu_torch.ops.chroma import (
        compact_candidates, estimate_tuning_bin, piptrack_candidates)
    from stutter_tpu_torch.ops.consts import PIP_FMAX, PIP_FMIN, band_range
    from stutter_tpu_torch.ops.spectromel import spectromel

    N, n = 163840, 160000
    n_fft, hop = (2048, 512) if with_stats else (512, 256)
    lo, hi = band_range(16000, n_fft, PIP_FMIN, PIP_FMAX)
    audio = _clips(9, 3, N)
    audio[0] = _comb(N, n, n_fft, lo, hi)
    audio = torch.from_numpy(audio).to(cuda)
    le = torch.tensor([n, n, n], dtype=torch.int32, device=cuda)
    audio[:, n:] = 0
    p, _, tb = spectromel(audio, le, n_fft=n_fft, hop_length=hop, with_stats=with_stats)
    counts = compact_candidates(*piptrack_candidates(p, 16000, n_fft))[2].sum(1)
    if with_stats:
        assert int(counts[0]) * 5 > 232448  # more than a block's shared memory
    assert torch.equal(tb, estimate_tuning_bin(p, 16000, n_fft)) and int(tb[2]) == 50


@pytest.mark.parametrize("B,T,K,n_valid", [
    (1, 97, 1025, [94]),  # one 3 s request: 24 groups over the cluster's 28 warps
    (1, 50, 1025, [50]),  # 13 groups: uneven among the blocks
    (3, 97, 1025, [0, 1, 97]),  # no frame, one frame, every frame
    (5, 321, 1025, [321, 200, 3, 160, 0]),  # the 10 s bucket
    (2, 33, 257, [33, 17]),  # n_fft 512: K = 257
])
def test_chroma_stats_cluster_shapes_match_plain(cuda, B, T, K, n_valid):
    """chroma_stats within 1e-5 of its plain version on power-like inputs,
    with more than one block per clip at B=1; frames past n_valid are not
    read (NaN there changes nothing)."""
    from stutter_tpu_torch.ops.chroma_stats import chroma_stats, chroma_stats_plain, cluster_size

    rng = np.random.RandomState(10 + B)
    p = torch.from_numpy((rng.rand(B, T, K) ** 4).astype(np.float32)).to(cuda)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=cuda)
    for b, v in enumerate(n_valid):
        p[b, v:] = 0.0
    tb = torch.from_numpy(rng.randint(0, 100, B).astype(np.int32)).to(cuda)
    ref = chroma_stats_plain(p, tb, nv, n_fft=2 * (K - 1))
    for b, v in enumerate(n_valid):
        p[b, v:] = float("nan")
    before = chroma_stats.launches
    got = chroma_stats(p, tb, nv, n_fft=2 * (K - 1))
    assert chroma_stats.launches == before + 1
    assert B > 1 or cluster_size(B, T) > 1
    assert float((got - ref).abs().max()) < 1e-5
    for b, v in enumerate(n_valid):
        if v == 0:
            assert not got[b].any()
    assert torch.equal(got, chroma_stats(p, tb, nv, n_fft=2 * (K - 1)))  # run to run
