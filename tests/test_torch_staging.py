"""The corpus path's reused host stages (ops/frontend.py's HostStage,
StagePool, pad_batch): a batch padded into a stage that holds stale
samples is bit for bit the batch a fresh `np.zeros` gives, nothing
`denoise_clips`, `run_bucketed` or `prepare_sequence_dataset` returns
aliases the stage, threads that call at once each get a stage of their
own, and, on the card, the stage is page-locked, reused from pass to pass
and counted as `pinned_bytes`."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stutter_tpu_torch.config import DenoiseConfig
from stutter_tpu_torch.denoise import denoise_clips
from stutter_tpu_torch.ops import frontend
from stutter_tpu_torch.ops.frontend import DEFAULT_BUCKETS, STAGES, pad_batch, run_bucketed
from stutter_tpu_torch.parallel.mesh import make_mesh
from stutter_tpu_torch.train.seq_trainer import prepare_sequence_dataset
from stutter_tpu_torch.utils import profiling as P


def _clips(seed, lengths):
    rng = np.random.RandomState(seed)
    return [(0.1 * rng.randn(n)).astype(np.float32) for n in lengths]


SHORT = (9000, 24576, 30000, 50000, 12000, 60000)  # three buckets, below the largest
LONG = (170000, 150000, 160000, 100000)  # the largest bucket, one cut to it


def _features(audio, lengths):
    """A stand-in batch_fn that every sample of a row moves, padding
    included: weighted row sums, absolute sums and the lengths."""
    w = torch.arange(1, audio.shape[1] + 1, dtype=audio.dtype) / audio.shape[1]
    return torch.stack([(audio * w).sum(1), audio.abs().sum(1), lengths.float()], 1)


def _zeros_pad(clips, idxs, bucket, rows, stage=None):
    """Padding as into a fresh np.zeros batch, the stage left untouched."""
    batch = np.zeros((rows, bucket), np.float32)
    lens = np.zeros(rows, np.int32)
    for j, i in enumerate(idxs):
        y = clips[i][:bucket]
        batch[j, : len(y)] = y
        lens[j] = len(y)
    return torch.from_numpy(batch), lens


def _call(owner, clips, mesh=1):
    if owner == "denoise_clips":
        return denoise_clips(clips, DenoiseConfig(), batch_size=3, device="cpu")
    if owner == "prepare_sequence_dataset":
        return prepare_sequence_dataset(clips, "logmel", batch=3, device="cpu")
    return run_bucketed(clips, _features, 3, batch_size=3, device="cpu",
                        mesh=make_mesh(devices=["cpu"] * mesh))


def _same(owner, a, b):
    if owner != "run_bucketed":  # per-clip arrays, or (frames, n_valid)
        return len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y)
                                        for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


def _copy(out):
    return [x.copy() for x in out] if isinstance(out, (list, tuple)) else out.copy()


def _stale_stage(stale, owner):
    """Leave the CPU stage the next call takes holding stale samples: NaN
    over a batch of the largest bucket, or what a call (or a pad) over
    clips of the largest bucket left there -> that stage."""
    if stale == "nan":
        with STAGES.checkout(False) as stage:
            stage.take(8, DEFAULT_BUCKETS[-1]).fill_(float("nan"))
    elif owner == "pad_batch":
        with STAGES.checkout(False) as stage:
            pad_batch(_clips(9, LONG), [0, 1, 2, 3], DEFAULT_BUCKETS[-1], 4, stage)
    else:
        _call(owner, _clips(9, LONG))
    return STAGES.free[False][-1]


@pytest.mark.parametrize("owner", ["pad_batch", "denoise_clips", "run_bucketed",
                                   "prepare_sequence_dataset"])
@pytest.mark.parametrize("stale", ["nan", "larger"])
def test_a_stale_stage_gives_what_fresh_zeros_give(owner, stale, monkeypatch):
    """A stage pre-filled with NaN, or left over from a larger bucket's
    batch: the padded batch and its lengths (rows past the clips too), and
    the outputs of the calls that pad through it, are bit for bit those of
    padding into a fresh np.zeros batch; the call took that stage."""
    clips = _clips(3, SHORT)
    stage = _stale_stage(stale, owner)
    assert stage.buf.numel() >= 4 * DEFAULT_BUCKETS[-1]
    if owner == "pad_batch":
        for idxs, bucket, rows in (([0, 1], 24576, 3), ([2, 3, 5], 98304, 4), ([4], 49152, 1)):
            with STAGES.checkout(False) as got_stage:
                batch, lens = pad_batch(clips, idxs, bucket, rows, got_stage)
                want, want_lens = _zeros_pad(clips, idxs, bucket, rows)
                assert got_stage is stage
                assert batch.dtype == want.dtype and torch.equal(batch, want)
                assert lens.dtype == want_lens.dtype and np.array_equal(lens, want_lens)
        return
    with monkeypatch.context() as m:
        m.setattr(frontend, "pad_batch", _zeros_pad)
        want = _call(owner, clips)
    assert STAGES.free[False][-1] is stage
    got = _call(owner, clips)
    assert STAGES.free[False][-1] is stage
    assert _same(owner, got, want)


@pytest.mark.parametrize("owner,mesh", [("denoise_clips", 1), ("run_bucketed", 1),
                                        ("run_bucketed", 2), ("prepare_sequence_dataset", 1)])
def test_results_outlive_the_next_call(owner, mesh):
    """A call's results are unchanged after a second call over other clips
    in other buckets, padded into the same stage: nothing returned aliases
    the stage."""
    first = _call(owner, _clips(4, SHORT[:3] + LONG[:1]), mesh)
    kept = _copy(first)
    stage = STAGES.free[False][-1]
    _call(owner, _clips(5, (40000, 70000, 20000, 90000, 5000)), mesh)
    assert STAGES.free[False][-1] is stage
    assert _same(owner, first, kept)


@pytest.mark.parametrize("owners", [("run_bucketed", "denoise_clips"),
                                    ("run_bucketed", "run_bucketed"),
                                    ("denoise_clips", "denoise_clips"),
                                    ("prepare_sequence_dataset", "run_bucketed")])
def test_threads_calling_at_once_get_what_serial_calls_get(owners):
    """Four threads calling the corpus path at once, two over each of two
    clip sets, three calls each, with the interpreter switching threads
    every microsecond, get what serial calls get: each call pads into a
    stage of its own."""
    work = [(owner, _clips(10 + k, SHORT[k::2] + LONG[k::2])) for k, owner in enumerate(owners)]
    serial = [_call(owner, clips) for owner, clips in work]
    got: list[list] = [[] for _ in range(4)]
    start = threading.Barrier(4)

    def run(t):
        start.wait()
        owner, clips = work[t % 2]
        for _ in range(3):
            got[t].append(_call(owner, clips))

    threads = [threading.Thread(target=run, args=(t,)) for t in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for t in range(4):
        owner = work[t % 2][0]
        assert len(got[t]) == 3
        assert all(_same(owner, g, serial[t % 2]) for g in got[t]), (t, owner)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the page-locked stage is for a CUDA device")
    from stutter_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
def test_on_the_card_the_stage_is_pinned_reused_and_counted(cuda, monkeypatch):
    """For a CUDA device every staged batch is page-locked; after a warm
    pass a second pass makes no new page-locked block
    (torch.cuda.host_memory_stats); traced, `<owner>.pinned_bytes` counts
    every batch's bytes, the h2d bytes less the lengths'."""
    from stutter_tpu_torch.config import FEATURES_149
    from stutter_tpu_torch.ops.frontend import batch_extractor_for

    clips = _clips(6, SHORT + LONG)
    fn = batch_extractor_for(FEATURES_149)
    staged = []

    def recording_pad(*args):
        batch, lens = pad_batch(*args)
        staged.append((batch.is_pinned(), batch.numel() * 4, lens.nbytes))
        return batch, lens

    def one_pass():
        denoise_clips(clips, DenoiseConfig(), batch_size=3, device=cuda)
        run_bucketed(clips, fn, 149, batch_size=3, device="cuda:0")
        prepare_sequence_dataset(clips, "logmel", batch=3, device=cuda)

    one_pass()
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    one_pass()
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    monkeypatch.setattr(frontend, "pad_batch", recording_pad)
    before = P.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        one_pass()
    added = {k: v - before.get(k, 0) for k, v in P.counters().items()}
    assert staged and all(pinned for pinned, _, _ in staged)
    owners = ("denoise_clips", "run_bucketed", "prepare_sequence_dataset")
    pinned = sum(added[f"{o}.pinned_bytes"] for o in owners)
    h2d = sum(added[f"{o}.h2d_bytes"] for o in owners)
    assert pinned == sum(b for _, b, _ in staged)
    assert h2d - pinned == sum(n for _, _, n in staged)
