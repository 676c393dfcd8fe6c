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


def _stats_clips(cuda, B, N, hop, n_valid, seed):
    """B clips in a bucket of N samples: the first len(n_valid) with those
    valid frame counts, the rest of random lengths from N / 4 to N (the last
    of two or more silent) -> (audio, lengths) on the card."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(N // 4, N + 1, size=B)
    for b, nv in enumerate(n_valid):
        lengths[b] = min((nv - 1) * hop + rng.randint(hop), N)
    audio = torch.from_numpy(_clips(seed, max(B, 2), N)[:B]).to(cuda)
    for b, n in enumerate(lengths):
        audio[b, n:] = 0
    return audio, torch.from_numpy(lengths.astype(np.int32)).to(cuda)


# the n_valid cases of tests/test_torch_spectromel_stats.py; "edge": a clip
# that ends on a block boundary of the launch's plan; "T": the whole bucket
STATS_N_VALID = (1, 5, 8, 9, 10, "edge", "T")


@pytest.mark.parametrize("B,N,n_fft,hop,cases", [
    (1, 49152, 2048, 512, (94,)),  # one 3 s request: 8 blocks of 13 frames
    (257, 49152, 2048, 512, STATS_N_VALID),  # past 256 clips: a block a clip
    (7, 24576, 2048, 512, STATS_N_VALID),  # 7 blocks of 7 frames
    (4, 163840, 2048, 512, ("T", 313, 200, 5)),  # the 10.1 s bucket, 321 frames
    (7, 24576, 1024, 128, STATS_N_VALID),  # the other FFT sizes at the ratios of
    (7, 24576, 512, 64, STATS_N_VALID),  # test_spectromel_kernel_at_other_fft_sizes_and_ratios
])
def test_spectromel_stats_launch_matches_plain(cuda, B, N, n_fft, hop, cases):
    """The stats launch (a cluster of blocks a clip) against the plain
    version, n_valid < 9 and a clip ending on a block boundary included."""
    from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
    from stutter_tpu_torch.ops.spectromel import spectromel, spectromel_plain, stats_plan

    T = N // hop + 1
    plan = stats_plan(B, T)
    resolve = {"edge": min(plan.rows * max(1, plan.cs // 2), T), "T": T}
    n_valid = [resolve.get(nv, nv) for nv in cases]
    audio, le = _stats_clips(cuda, B, N, hop, n_valid, seed=14)
    kw = dict(n_fft=n_fft, hop_length=hop)
    before = spectromel.launches
    p, st, tb = spectromel(audio, le, **kw)
    assert spectromel.launches == before + 1
    pp, stp, _ = spectromel_plain(audio, le, **kw)
    assert st.shape == (B, 6, 20) and bool(torch.isfinite(st).all())
    assert float((p - pp).abs().max() / pp.abs().max()) < 1e-5
    err = (st - stp).abs()
    assert float(err.max()) < 2e-3 and float(err.mean()) < 2e-4
    for b in range(len(n_valid)):  # each n_valid case on its own
        assert float(err[b].max()) < 2e-3 and float(err[b].mean()) < 2e-4, n_valid[b]
    assert torch.equal(tb, estimate_tuning_bin(p, 16000, n_fft))


def test_spectromel_stats_do_not_depend_on_the_batch(cuda):
    """A clip's stats are the same bits alone (a cluster of 8 blocks), in a
    batch of 64 (2 blocks a clip) and in a batch of 256 (one block): each
    column sums in the one-block kernel's order whatever the split."""
    from stutter_tpu_torch.ops.spectromel import spectromel, stats_plan

    for N, length in ((49152, 48000), (163840, 160000)):
        audio, le = _stats_clips(cuda, 256, N, 512, (1 + length // 512,), seed=16)
        alone = spectromel(audio[:1], le[:1])[1]
        assert [stats_plan(B, N // 512 + 1).cs for B in (1, 64, 256)] == [8, 2, 1]
        for B in (64, 256):
            assert torch.equal(spectromel(audio[:B], le[:B])[1][:1], alone), (N, B)


def test_spectromel_stats_launch_is_bitwise_repeatable(cuda):
    """Two launches on the same input give the same stats bit for bit: the
    partial sums join in rank order, with no float atomics."""
    from stutter_tpu_torch.ops.spectromel import spectromel

    for B, N in ((1, 49152), (64, 48128), (256, 49152)):
        audio, le = _stats_clips(cuda, B, N, 512, (), seed=15)
        first = spectromel(audio, le)[1].clone()
        for _ in range(3):
            assert torch.equal(spectromel(audio, le)[1], first)


def test_mel_mode_without_tuning_skips_only_the_tail(cuda):
    """with_tuning=False (the sequence featurizer): the same power and mel
    bit for bit, no tuning bin, one mel-mode launch."""
    from stutter_tpu_torch.ops.spectromel import spectromel

    audio = torch.from_numpy(_clips(11, 3, 49152)).to(cuda)
    le = torch.tensor([49152, 30000, 49152], dtype=torch.int32, device=cuda)
    audio[1, 30000:] = 0
    p, m, tb = spectromel(audio, le, with_stats=False)
    before = spectromel.mel_launches
    p2, m2, tb2 = spectromel(audio, le, with_stats=False, with_tuning=False)
    assert spectromel.mel_launches == before + 1 and tb2 is None and tb.shape == (3,)
    assert torch.equal(p, p2) and torch.equal(m, m2)


def test_kernels_at_the_stream_shapes(cuda):
    """The ensemble stream's segment, one [1, 2**20] buffer (4,334 gate
    chunks, 2,049 frames), through the gate and the mel mode; the MLP
    stream's windows, [64, 48128] (95 frames), through the stats mode and
    chroma_stats: each within its kernel bound of its plain version."""
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
    from stutter_tpu_torch.ops.chroma_stats import chroma_stats, chroma_stats_plain
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate_plain
    from stutter_tpu_torch.ops.spectromel import spectromel, spectromel_plain

    seg = torch.from_numpy(_clips(12, 2, 1 << 20)[:1]).to(cuda)
    le = torch.tensor([1_000_000], dtype=torch.int32, device=cuda)
    seg[:, 1_000_000:] = 0
    got = denoise_batch(seg, le, DenoiseConfig())
    ref = denoise_batch(seg, le, DenoiseConfig(), gate=spectral_gate_plain)
    g, r = got - got.mean(), ref - ref.mean()
    assert float((got - ref).abs().max()) < 0.03
    assert float((g * r).sum() / (g.norm() * r.norm())) > 0.9999
    p, m, tb = spectromel(got, le, with_stats=False, with_tuning=False)
    pp, mp, _ = spectromel_plain(got, le, with_stats=False, with_tuning=False)
    assert tb is None and m.shape == (1, 2049, 128)
    assert float((p - pp).abs().max() / pp.abs().max()) < 1e-5
    assert float((m - mp).abs().max() / mp.abs().max()) < 1e-4

    win = torch.from_numpy(_clips(13, 64, 48128)).to(cuda)
    lw = torch.full((64,), 48128, dtype=torch.int32, device=cuda)
    lw[-3:] = torch.tensor([47000, 20000, 1], dtype=torch.int32, device=cuda)
    for b, n in enumerate(lw.tolist()):
        win[b, n:] = 0
    p, st, tb = spectromel(win, lw)
    pp, stp, _ = spectromel_plain(win, lw)
    assert p.shape == (64, 95, 1025)
    assert float((p - pp).abs().max() / pp.abs().max()) < 1e-5
    err = (st - stp).abs()
    assert float(err.max()) < 2e-3 and float(err.mean()) < 2e-4
    assert torch.equal(tb, estimate_tuning_bin(p, 16000, 2048))
    nv = 1 + lw // 512
    assert float((chroma_stats(p, tb, nv) - chroma_stats_plain(p, tb, nv)).abs().max()) < 1e-5


def test_heads_vote_and_streams_on_the_card_match_the_cpu(cuda, tmp_path):
    """The quint at its published widths, random weights from a numpy seed:
    EnsemblePredictor on the card against the CPU's plain path (the same
    label, probabilities within 1e-3), predict_batch against predict_clip,
    the stream through the vote."""
    import json

    from stutter_tpu_torch.infer import EnsemblePredictor
    from stutter_tpu_torch.train.seq_pipeline import ARCHS, persist_seq_head

    rng = np.random.RandomState(14)
    archs = ["cnn", "cnn_bilstm", "transformer", "transformer_lr1e3", "transformer_mix4_lr1e3"]
    for a in archs:
        D = 60 if a == "cnn_bilstm" else 128
        persist_seq_head(str(tmp_path), a, ARCHS[a]["init_fn"](rng, **ARCHS[a]["init_kwargs"](3)),
                         rng.randn(D).astype(np.float32) - (30 if D == 128 else 0),
                         1 + 10 * rng.rand(D).astype(np.float32), ["a", "b", "c"])
    (tmp_path / "ensemble.json").write_text(json.dumps(
        {"weights": {a: 0.2 for a in archs}, "classes": ["a", "b", "c"]}))
    gpu = EnsemblePredictor.load(str(tmp_path), device=cuda)
    cpu = EnsemblePredictor.load(str(tmp_path), device="cpu")
    clips = [c[:n] for c, n in zip(_clips(15, 3, 49152), (49152, 20000, 9000))]
    batch = gpu.predict_batch(clips)
    for y, b in zip(clips, batch):
        a, c = gpu.predict_clip(y), cpu.predict_clip(y)
        assert a["label"] == c["label"] == b["label"]
        assert max(abs(a["proba"][k] - c["proba"][k]) for k in "abc") < 1e-3
        assert max(abs(a["proba"][k] - b["proba"][k]) for k in "abc") < 1e-5
    y = _clips(16, 2, 16000 * 5)[0]  # the last clip of _clips is silent
    w, wc = gpu.predict_stream(y, window_s=1.0, hop_s=1.0), cpu.predict_stream(y, window_s=1.0,
                                                                              hop_s=1.0)
    assert [x["start_s"] for x in w] == [x["start_s"] for x in wc]
    assert max(abs(x["proba"][k] - z["proba"][k]) for x, z in zip(w, wc) for k in "abc") < 1e-3


def test_fed_training_steps_on_the_card_equal_the_cpu(cuda):
    """Five GridTrainer steps at the published widths (149-256-128-64-3,
    G = 6, batch 128), the batch rows and dropout masks fed, each held on
    its own to FP64 from the state of an FP64 run of the same steps on the
    CPU (chip_smoke.check_fed_steps): the card's loss within 1e-5 relative,
    its gradients within 1e-4 normwise per entry and tensor with its own
    sign at the ReLU gates that rounding decides, Adam's update given its
    gradient within 1e-4; the card's recomputed pre-activations bitwise
    equal.  Then batches drawn on the card never take a padded row."""
    import chip_smoke
    from stutter_tpu_torch.train.trainer import MLPTrainConfig, draw_batch

    cfg = MLPTrainConfig()
    G, N, steps = 6, 300, 5
    rng = np.random.RandomState(17)
    X = rng.randn(G, N, 149).astype(np.float32)
    y = rng.randint(0, 3, (G, N))
    idx = rng.randint(0, N, (steps, G, cfg.batch_size))
    keeps = [[rng.rand(G, cfg.batch_size, h) < 1 - cfg.dropout for h in cfg.hidden]
             for _ in range(steps)]
    checked, _ = chip_smoke.check_fed_steps(cuda, X, y, idx, keeps, range(42, 42 + G), cfg)
    assert len(checked) == steps
    for s in checked:
        assert s["ok"] and s["bitwise"], s

    w = torch.ones(G, N, device=cuda)
    w[:, 200:] = 0
    gen = torch.Generator(device=cuda).manual_seed(0)
    Xd = torch.from_numpy(X).to(cuda)
    for _ in range(20):
        _, _, wb, kept = draw_batch(Xd, torch.from_numpy(y).to(cuda), w, cfg, gen)
        assert bool((wb == 1).all()) and kept[0].device.type == "cuda"


@pytest.mark.parametrize("arch", ["cnn", "cnn_bilstm", "transformer"])
def test_fed_seq_grid_steps_on_the_card_equal_the_cpu(cuda, arch):
    """Three steps of a sequence-head grid at the published widths (G = 2,
    batch 16, t_max 316, mixup and SpecAugment on), the same initial
    weights and draws fed to both: the card's weights equal the CPU's
    within 1e-4 relative, normwise per tensor."""
    from stutter_tpu_torch.train.seq_pipeline import ARCHS
    from stutter_tpu_torch.train.seq_trainer import (
        GridSteps, SeqGrid, SeqGridTrainer, SeqTrainConfig, draw_steps, row_targets)

    spec = ARCHS[arch]
    D = 60 if spec["kind"] == "mfcc_deltas" else 128
    rng = np.random.RandomState(18)
    N, G, steps = 40, 2, 3
    nv = rng.randint(20, 317, N)
    X = rng.randn(N, 316, D).astype(np.float32) * (np.arange(316)[None] < nv[:, None])[..., None]
    y = rng.randint(0, 3, N)
    cfg = SeqTrainConfig(batch_size=16, mixup_alpha=0.2, time_masks=1, freq_masks=1)
    inits = [spec["init_fn"](np.random.RandomState(s), **spec["init_kwargs"](3)) for s in (1, 2)]
    draws = [draw_steps(s, np.ones(N), nv, steps, cfg, D) for s in (1, 2)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        grid = SeqGrid(spec["module"], inits, dev)
        trainer = SeqGridTrainer(grid, cfg, 100)
        feed = GridSteps(X, nv, row_targets(y, 3, cfg), np.zeros((G, D)), np.ones((G, D)), draws,
                         (1, 2), cfg, dev)
        for t in range(steps):
            trainer.step(*feed.batch(t))
        out[dev.type] = grid.params()
    for g in range(G):
        for k, ref in out["cpu"][g].items():  # normwise: see chip_smoke.step_errors
            assert np.linalg.norm(out["cuda"][g][k] - ref) / np.linalg.norm(ref) < 1e-4, (g, k)


def test_kernels_launch_on_their_tensors_device_not_the_current_one(cuda):
    """Each kernel on the last visible GPU while the current device stays
    cuda:0: within its bound of the plain version there, its output on that
    device, the current device unchanged.  One card cannot show this (its
    tensor's device is always the current one), so it skips below two."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: on one card a tensor's device is always the current one")
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.ops.chroma_stats import chroma_stats, chroma_stats_plain
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate_plain
    from stutter_tpu_torch.ops.spectromel import spectromel, spectromel_plain

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    audio = torch.from_numpy(_clips(19, 3, 49152)).to(last)
    le = torch.tensor([49152, 30000, 49152], dtype=torch.int32, device=last)
    audio[1, 30000:] = 0
    p, st, tb = spectromel(audio, le)
    pp, stp, _ = spectromel_plain(audio, le)
    assert p.device == st.device == tb.device == last
    assert float((p - pp).abs().max() / pp.abs().max()) < 1e-5
    assert float((st - stp).abs().max()) < 2e-3
    p, m, _ = spectromel(audio, le, n_fft=512, hop_length=256, with_stats=False)
    _, mp, _ = spectromel_plain(audio, le, n_fft=512, hop_length=256, with_stats=False)
    assert m.device == last and float((m - mp).abs().max() / mp.abs().max()) < 1e-4
    p, _, tb = spectromel(audio, le)
    nv = 1 + le // 512
    got = chroma_stats(p, tb, nv)
    assert got.device == last
    assert float((got - chroma_stats_plain(p, tb, nv)).abs().max()) < 1e-5
    got = denoise_batch(audio, le, DenoiseConfig())
    ref = denoise_batch(audio, le, DenoiseConfig(), gate=spectral_gate_plain)
    assert got.device == last and float((got - ref).abs().max()) < 0.03
    assert torch.cuda.current_device() == 0


def test_sharded_paths_on_a_split_of_one_card_equal_unsharded(cuda):
    """make_mesh(devices=[cuda:0] * 2): the front end and the gate cut into
    two shards on one card and gathered in order equal the batch unsharded
    (which checks the split and the gather, not two devices)."""
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.ops.frontend import extract_features_149_batch
    from stutter_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(devices=[M.make_mesh()[0]] * 2)
    audio = _clips(20, 4, 49152)
    lengths = np.array([49152, 30000, 12000, 49152], np.int32)
    for b, n in enumerate(lengths):
        audio[b, n:] = 0
    a, n = torch.from_numpy(audio).to(mesh[0]), torch.from_numpy(lengths).to(mesh[0])
    feats = M.extract_features_sharded(mesh, audio, lengths)
    assert np.abs(feats - extract_features_149_batch(a, n).cpu().numpy()).max() <= 1e-5
    gated = M.denoise_sharded(mesh, audio, lengths)
    assert np.abs(gated - denoise_batch(a, n).cpu().numpy()).max() <= 1e-5


@pytest.mark.parametrize("B,T", [(64, 45), (64, 136), (64, 440), (9, 440), (1, 511)])
def test_gated_attention_kernel_matches_plain(cuda, B, T):
    """WavLM's attention kernel at the corpus cell's fitted batches, their
    last 9 rows and one request, q, k, v read by strides from one [B, T,
    3072] tensor, ragged clips and one of no frames: every row i <
    max(T_b, 1) within 1e-5 of the plain version on the CPU (|got - ref| /
    (1 + |ref|)), every row past it zero, one launch a call, no device
    memory beyond the output (no [B, 16, T, T] tensor), and the pairs the
    kernel reports it multiplied equal to attn_pairs_run x heads, the
    counted call's output the same bit for bit."""
    from stutter_tpu_torch.tools.kernel_phases import attention_check

    res = attention_check(B, T, cuda)
    assert res["gap"] <= 1e-5, res["gap"]
    assert res["padded_rows_zero"]
    assert res["launches"] == 1
    assert res["extra_bytes"] <= 1 << 20
    assert res["pairs"] == res["pairs_run"] and res["counted_call_equal"]


def test_gated_attention_kernel_rejects_what_it_does_not_take(cuda):
    """A CUDA tensor of another dtype or layout raises instead of running
    (no fallback): float64 activations, a q whose last stride is not 1, a q
    off 16-byte alignment, int64 frames, and a head width of 16 (the
    kernel takes 64 only)."""
    from stutter_tpu_torch.config import WavLMConfig
    from stutter_tpu_torch.models import wavlm as W
    from stutter_tpu_torch.tools.kernel_phases import attention_inputs

    p, cfg, x, q, k, v, frames = attention_inputs(2, 45, 7, cuda)
    wide = torch.randn(2, 45, 1025, device=cuda)
    bad = {"float64": dict(x=x.double()),
           "last stride": dict(q=torch.randn(2, 1024, 45, device=cuda).transpose(1, 2)),
           "alignment": dict(q=wide[..., 1:]),
           "int64 frames": dict(frames=frames.long())}
    for what, swap in bad.items():
        args = {**dict(x=x, q=q, k=k, v=v, frames=frames), **swap}
        with pytest.raises(ValueError):
            W.gated_attention(p, 0, args["x"], args["q"], args["k"], args["v"],
                              args["frames"], cfg)
    p16, narrow, *acts, f16 = attention_inputs(
        2, 45, 7, cuda, WavLMConfig(hidden_size=256, num_attention_heads=16))
    with pytest.raises(ValueError, match="heads x 64"):
        W.gated_attention(p16, 0, *acts, f16, narrow)


@pytest.mark.parametrize("B,T", [(64, 45), (64, 136), (64, 440), (9, 440), (1, 511)])
def test_relkey_attention_kernel_matches_plain(cuda, B, T):
    """The kernel's relative-key mode (W2V-BERT 2.0's attention core) on
    packed rows at the corpus cell's fitted batches' clips, their last 9
    and one request, q, k, v read by strides from one [R, 3072] tensor,
    each clip's rows from its offset, ragged clips and one of no frames
    (no row): every clip's rows within 1e-5 of relkey_attention_plain on
    the CPU, one launch a call, no device memory beyond the output (no [B,
    16, T, T] tensor), and the pairs the kernel reports it multiplied equal
    to attn_pairs_run x heads, the counted call's output the same bit for
    bit."""
    from stutter_tpu_torch.tools.kernel_phases import attention_check

    res = attention_check(B, T, cuda, "relkey")
    assert res["gap"] <= 1e-5, res["gap"]
    assert res["padded_rows_zero"]
    assert res["launches"] == 1
    assert res["extra_bytes"] <= 1 << 20
    assert res["pairs"] == res["pairs_run"] and res["counted_call_equal"]


def test_relkey_attention_kernel_rejects_what_it_does_not_take(cuda):
    """A CUDA tensor of another dtype or layout raises instead of running:
    float64 q, a q whose last stride is not 1, a q off 16-byte alignment,
    padded [B, T, D] rows, int64 offsets, offsets of other rows than q's,
    more than 80 distances, and a head width of 16."""
    import dataclasses

    from stutter_tpu_torch.config import W2VBertConfig
    from stutter_tpu_torch.models import w2v_bert as W
    from stutter_tpu_torch.tools.kernel_phases import attention_inputs

    p, cfg, q, k, v, clips = attention_inputs(2, 45, 7, cuda, mode="relkey")
    R = q.shape[0]
    wide = torch.randn(R, 1025, device=cuda)
    bad = {"float64": dict(q=q.double()),
           "last stride": dict(q=torch.randn(1024, R, device=cuda).T),
           "alignment": dict(q=wide[:, 1:]),
           "padded": dict(q=q[None], k=k[None], v=v[None]),
           "int64 offsets": dict(clips=clips._replace(offsets=clips.offsets.long())),
           "rows": dict(clips=W.pack_clips(clips.frames + 1, cuda))}
    for what, swap in bad.items():
        args = {**dict(q=q, k=k, v=v, clips=clips), **swap}
        with pytest.raises(ValueError):
            W.relkey_attention(p, 0, args["q"], args["k"], args["v"], args["clips"], cfg)
    far = dataclasses.replace(cfg, left_max_position_embeddings=72)
    p81, *_ = attention_inputs(2, 45, 7, cuda, far, "relkey")
    with pytest.raises(ValueError, match="at most 80"):
        W.relkey_attention(p81, 0, q, k, v, clips, far)
    p16, narrow, *acts, c16 = attention_inputs(
        2, 45, 7, cuda, W2VBertConfig(hidden_size=256, num_attention_heads=16), "relkey")
    with pytest.raises(ValueError, match="heads x 64"):
        W.relkey_attention(p16, 0, *acts, c16, narrow)


@pytest.mark.parametrize("frames", [[1, 30, 31, 45, 440], [440, 0, 1, 0], [31], [2] * 64,
                                    "64x136"])
def test_glu_depthwise_kernel_matches_plain(cuda, frames):
    """The conv module's kernel (GLU and causal depthwise conv on packed
    rows, W2V-BERT 2.0's 1024 channels and 31 taps) on ragged clips of 1,
    30, 31, 45 and 440 frames, clips of no frame, one clip, many short ones
    and the corpus cell's 64 x 136 batch's clips: within 1e-5 of
    glu_depthwise_plain (|got - ref| / (1 + |ref|)), one launch a call,
    no device memory beyond the output, nothing written past row R of a
    larger buffer, the same rows bit for bit."""
    from stutter_tpu_torch.tools.kernel_phases import clip_frames, conv_check

    if frames == "64x136":
        frames = clip_frames(64, 136, 64136).tolist()
    res = conv_check(frames, cuda)
    assert res["gap"] <= 1e-5, res["gap"]
    assert res["launches"] == 1
    assert res["extra_bytes"] <= 1 << 20
    assert not res["written_past_rows"] and res["again_equal"]


def test_glu_depthwise_kernel_rejects_what_it_does_not_take(cuda):
    """A CUDA tensor the kernel does not take raises instead of running:
    float64 x, a non-contiguous x, padded [B, T, 2 C] rows, 15 taps, 48
    channels (not a multiple of 32), int64 offsets, offsets of other rows
    than x's."""
    from stutter_tpu_torch.models import w2v_bert as W
    from stutter_tpu_torch.tools.kernel_phases import conv_inputs

    x, w, clips = conv_inputs([30, 45], 0, cuda)
    bad = {"float64": dict(x=x.double()),
           "strided": dict(x=torch.randn(2048, x.shape[0], device=cuda).T),
           "padded": dict(x=x[None]),
           "15 taps": dict(w=w[..., :15].contiguous()),
           "48 channels": dict(x=x[:, :96].contiguous(), w=w[:48].contiguous()),
           "int64 offsets": dict(clips=clips._replace(offsets=clips.offsets.long())),
           "rows": dict(clips=W.pack_clips([31, 45], cuda))}
    for what, swap in bad.items():
        args = {**dict(x=x, w=w, clips=clips), **swap}
        with pytest.raises(ValueError):
            W.glu_depthwise(args["x"], args["w"], args["clips"])
