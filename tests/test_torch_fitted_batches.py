"""How ops/frontend.run_bucketed forms its batches: fitted_groups (the
clips by length, each batch padded to its longest clip in whole frame
strides) for a batch_fn that carries a `frame_stride`, bucket_groups
(DEFAULT_BUCKETS, the clips in input order) for every other.  The
encoder's own rows under both groupings are held in
tests/test_torch_wavlm.py."""

import math

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from stutter_tpu_torch.config import FEATURES_149, WavLMConfig
from stutter_tpu_torch.models.wavlm import frame_lengths
from stutter_tpu_torch.ops import frontend
from stutter_tpu_torch.ops.frontend import (DEFAULT_BUCKETS, batch_extractor_for, fitted_groups,
                                            pad_to_bucket, run_bucketed)
from stutter_tpu_torch.parallel.mesh import make_mesh
from stutter_tpu_torch.utils import profiling as P

CAP = DEFAULT_BUCKETS[-1]


def _corpus_lengths() -> np.ndarray:
    """The 905 clip lengths (samples at 16 kHz) of the embedding corpus:
    a lognormal of median 2.07 s and sigma 0.536 truncated to [0.45,
    10.09] s by redrawing, from shape seed 20261 (numpy's default_rng
    seeded with [shape seed, n])."""
    n = 905
    rng = np.random.default_rng([20261, n])
    out = np.empty(0)
    while out.size < n:
        d = rng.lognormal(math.log(2.07), 0.536, 2 * n)
        out = np.concatenate([out, d[(d >= 0.45) & (d <= 10.09)]])
    return (out[:n] * 16000).astype(np.int64)


def test_fitted_groups_on_the_corpus_lengths():
    """At WavLM-Large's strides (320 samples a frame) and batches of 64:
    every clip once, every N a multiple of 320 at or above its batch's
    longest clip and at most the cap, and the frames and attention pairs
    sent over those the clips need at 1.10 and 1.27 (the buckets send
    1.44 and 2.09)."""
    cfg = WavLMConfig()
    step = math.prod(cfg.conv_stride)
    lengths = _corpus_lengths()
    groups = fitted_groups(lengths, 64, step, CAP)
    idxs = [i for _, c in groups for i in c]
    assert sorted(idxs) == list(range(len(lengths))) and len(groups) == 15
    assert all(len(c) == 64 for _, c in groups[:-1])
    for N, c in groups:
        assert N % step == 0 and min(int(lengths[c].max()), CAP) <= N <= CAP

    def waste(groups):
        frames = pairs = vf = vp = 0
        for N, c in groups:
            T = frame_lengths(N, cfg)
            t = np.array([frame_lengths(int(min(n, CAP)), cfg) for n in lengths[c]])
            frames, pairs = frames + len(c) * T, pairs + len(c) * T * T
            vf, vp = vf + t.sum(), vp + (t * t).sum()
        return frames / vf, pairs / vp

    frames, pairs = waste(groups)
    assert abs(frames - 1.10) <= 0.01 and abs(pairs - 1.27) <= 0.01
    buckets = waste(frontend.bucket_groups(lengths, 64))
    assert buckets[0] > 1.4 and buckets[1] > 2.0


def test_fitted_groups_cut_to_the_cap_and_keep_one_stride():
    """A clip past the cap is cut to it (its batch's N is the cap); a clip
    of no sample still gets a batch one stride wide; equal lengths keep
    their input order."""
    groups = fitted_groups([200_000, 0, 640, 640, 5], 2, 320, CAP)
    assert groups == [(320, [1, 4]), (640, [2, 3]), (CAP, [0])]


def _clips():
    rng = np.random.RandomState(11)
    return [(0.1 * rng.randn(n)).astype(np.float32)
            for n in (9000, 60000, 24576, 30000, 170000, 12000, 50000, 100000, 401)]


@pytest.mark.parametrize("owner,mesh", [("run_bucketed", 1), ("run_bucketed", 2),
                                        ("denoise_clips", 1)])
def test_149_dim_batches_are_the_buckets_batches(owner, mesh, monkeypatch):
    """The 149-dim batch_fn carries no stride, so run_bucketed forms the
    DEFAULT_BUCKETS batches, and so does denoise_clips (the gate): the
    buckets in the order they first come up, each bucket's clips in input
    order in chunks of batch_size, the rows rounded up to the mesh and N
    the bucket; traced, every one of them is counted."""
    import stutter_tpu_torch.denoise as dn

    clips = _clips()
    fn = batch_extractor_for(FEATURES_149)
    assert not hasattr(fn, "frame_stride")
    formed = []
    orig = frontend.pad_batch

    def pad_batch(clips, idxs, bucket, rows, stage):
        formed.append((list(idxs), bucket, rows))
        return orig(clips, idxs, bucket, rows, stage)

    monkeypatch.setattr(frontend, "pad_batch", pad_batch)
    # the gate is not under test here: a stand-in of its shape
    monkeypatch.setattr(dn, "denoise_batch", lambda audio, lengths, cfg: audio * 0.5)
    before = P.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        if owner == "denoise_clips":
            got = dn.denoise_clips(clips, batch_size=2, device="cpu")
            assert all(np.array_equal(g, 0.5 * y[:CAP]) for g, y in zip(got, clips))
        else:
            run_bucketed(clips, fn, 149, batch_size=2, device="cpu",
                         mesh=make_mesh(devices=["cpu"] * mesh))
    added = {k: v - before.get(k, 0) for k, v in P.counters().items()}
    by: dict[int, list[int]] = {}
    for i, y in enumerate(clips):
        by.setdefault(pad_to_bucket(len(y)), []).append(i)
    want = [(c[s : s + 2], b, -(-len(c[s : s + 2]) // mesh) * mesh)
            for b, c in by.items() for s in range(0, len(c), 2)]
    assert formed == want
    assert [(c, b) for c, b, _ in want] == [(c, b) for b, c in
                                            frontend.bucket_groups([len(y) for y in clips], 2)]
    assert added[f"{owner}.batches"] == len(want)
    assert added[f"{owner}.pad_samples"] == sum(b * rows for _, b, rows in want)
