"""The port's spans and counters (utils/profiling.py's span, count,
counters, spans) and the corpus path's use of them: with no profiler
recording they cost a flag check and record nothing; under a profiler,
`denoise_clips`, `run_bucketed` and `prepare_sequence_dataset` (the one
host batch loop, ops/frontend.host_batches) emit their "stp." spans,
nested per batch with sibling leaves that do not overlap, count the work
of each batch, and return what an untraced call returns."""

import json
import logging
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stutter_tpu_torch.config import DenoiseConfig
from stutter_tpu_torch.denoise import denoise_clips
from stutter_tpu_torch.ops.frontend import DEFAULT_BUCKETS, pad_to_bucket, run_bucketed
from stutter_tpu_torch.parallel.mesh import make_mesh
from stutter_tpu_torch.train.seq_trainer import prepare_sequence_dataset
from stutter_tpu_torch.utils import profiling as P

LEAVES = {"denoise_clips": ("pad", "h2d", None, "d2h", "unpad"),
          "run_bucketed": ("pad", "h2d", "launch", "d2h", "scatter"),
          "prepare_sequence_dataset": ("pad", "h2d", "launch", "d2h", "unpad")}


def _clips():
    """Seven clips over three buckets, one longer than the largest bucket
    (cut to it)."""
    rng = np.random.RandomState(5)
    return [(0.1 * rng.randn(n)).astype(np.float32)
            for n in (9000, 24576, 30000, 50000, 12000, 170000, 60000)]


def _leaf_names(owner):
    return [f"{owner}.{x}" if x else "denoise_batch" for x in LEAVES[owner]]


def _features(audio, lengths):
    """A stand-in batch_fn: row sums and lengths."""
    return torch.stack([audio.sum(1), lengths.float()], 1)


def _traced(fn, tmp_path):
    """fn() under a CPU profiler -> (its output, the trace's "stp." events,
    the in-memory spans and the counters it added)."""
    before_c, before_s = P.counters(), len(P.spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("name", "").startswith(P.SPAN_PREFIX)]
    added = {k: v - before_c.get(k, 0) for k, v in P.counters().items()
             if v != before_c.get(k, 0)}
    return out, events, P.spans()[before_s:], added


def _batches(clips, batch_size, rows=lambda n: n):
    """(rows x bucket, valid samples, rows, bucket) of each padded batch."""
    by = {}
    for y in clips:
        b = pad_to_bucket(len(y), DEFAULT_BUCKETS)
        by.setdefault(b, []).append(min(len(y), b))
    return [(rows(len(c)) * b, sum(c), rows(len(c)), b)
            for b, ns in by.items() for c in (ns[s : s + batch_size]
                                              for s in range(0, len(ns), batch_size))]


def test_with_no_profiler_span_and_count_record_nothing(monkeypatch):
    """No profiler recording: span() is the shared no-op context and never
    builds a record_function; count() and the span leave the in-memory
    record as it was."""
    assert not P.tracing()

    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before_c, before_s = P.counters(), P.spans()
    for _ in range(3):
        with P.span("denoise_clips.pad") as s:
            assert s is None
        P.count("denoise_clips.h2d_bytes", 1024)
    assert P.span("a") is P.span("b")
    assert P.counters() == before_c and P.spans() == before_s


@pytest.mark.parametrize("owner", ["denoise_clips", "run_bucketed", "prepare_sequence_dataset"])
def test_corpus_path_spans_nest_per_batch_with_disjoint_leaves(owner, tmp_path):
    """Each call is one `<owner>` span; each batch one `<owner>.batch` span
    inside it, holding its five leaves once each, in order, without
    overlap; the trace's ranges and the in-memory record agree, on the
    calling thread."""
    import threading

    clips = _clips()
    if owner == "denoise_clips":
        fn = lambda: denoise_clips(clips, DenoiseConfig(), batch_size=2, device="cpu")  # noqa: E731
    elif owner == "prepare_sequence_dataset":
        fn = lambda: prepare_sequence_dataset(clips, "logmel", batch=2, device="cpu")  # noqa: E731
    else:
        fn = lambda: run_bucketed(clips, _features, 2, batch_size=2, device="cpu")  # noqa: E731
    _, events, mem, _ = _traced(fn, tmp_path)
    n_batches = len(_batches(clips, 2))
    for source, items in (("trace", [(e["name"][len(P.SPAN_PREFIX):], float(e["ts"]),
                                      float(e["ts"]) + float(e["dur"]), e["tid"])
                                     for e in events]),
                          ("memory", [(s.name, s.start_ns * 1e-3, s.end_ns * 1e-3, s.tid)
                                      for s in mem])):
        assert {t for *_, t in items} == {threading.get_native_id()}, source
        items = sorted(items, key=lambda x: x[1])
        (top,) = [x for x in items if x[0] == owner]
        batches = [x for x in items if x[0] == f"{owner}.batch"]
        assert len(batches) == n_batches, source
        leaves = [x for x in items if x[0] in _leaf_names(owner)]
        assert len(leaves) == 5 * n_batches
        assert len(items) == 1 + 6 * n_batches, (source, sorted({x[0] for x in items}))
        for b in batches:
            assert top[1] <= b[1] and b[2] <= top[2]
            inner = [x for x in leaves if b[1] <= x[1] and x[2] <= b[2]]
            assert [x[0] for x in inner] == _leaf_names(owner), source
            assert all(a[2] <= c[1] for a, c in zip(inner, inner[1:])), source


@pytest.mark.parametrize("owner,mesh", [("denoise_clips", 1), ("run_bucketed", 1),
                                        ("run_bucketed", 2), ("prepare_sequence_dataset", 1)])
def test_corpus_path_counters_equal_a_hand_count(owner, mesh, tmp_path):
    """batches, pad_samples (rows x bucket, rows rounded up to the mesh),
    valid_samples (each clip cut to its bucket) and h2d_bytes (the padded
    float32 audio and the int32 lengths) for clips of known lengths, and no
    other counter; a traced call returns what an untraced one does, bit
    for bit."""
    clips = _clips()
    m = make_mesh(devices=["cpu"] * mesh)

    def fn():
        if owner == "denoise_clips":
            return denoise_clips(clips, DenoiseConfig(), batch_size=3, device="cpu")
        if owner == "prepare_sequence_dataset":
            return prepare_sequence_dataset(clips, "mfcc_deltas", batch=3, device="cpu")
        return run_bucketed(clips, _features, 2, batch_size=3, device="cpu", mesh=m)

    rows = lambda n: -(-n // mesh) * mesh  # noqa: E731
    plain = fn()
    got, _, _, counted = _traced(fn, tmp_path)
    batches = _batches(clips, 3, rows)
    pad = sum(b[0] for b in batches)
    assert counted == {f"{owner}.batches": len(batches), f"{owner}.pad_samples": pad,
                       f"{owner}.valid_samples": sum(b[1] for b in batches),
                       f"{owner}.h2d_bytes": pad * 4 + sum(b[2] for b in batches) * 4}
    assert counted[f"{owner}.valid_samples"] == sum(min(len(y), DEFAULT_BUCKETS[-1])
                                                    for y in clips)
    # on the CPU nothing goes from page-locked memory: counted, and 0
    assert P.counters()[f"{owner}.pinned_bytes"] == 0
    if owner == "denoise_clips":
        assert len(got) == len(plain) and all(np.array_equal(a, b) for a, b in zip(got, plain))
        assert all(g.dtype == p.dtype for g, p in zip(got, plain))
    elif owner == "prepare_sequence_dataset":
        assert all(np.array_equal(g, p) and g.dtype == p.dtype for g, p in zip(got, plain))
    else:
        assert np.array_equal(got, plain) and got.dtype == plain.dtype


def test_stages_are_spans_and_trace_logs_its_counters(tmp_path, caplog):
    """A StageTimer stage is the parent span of the calls inside it, and
    trace() logs the counters its region counted."""
    clips = _clips()[:3]
    timer = P.StageTimer()
    with caplog.at_level(logging.INFO, logger="stutter_tpu_torch.profiling"):
        with P.trace(str(tmp_path / "t"), device="cpu"):
            with timer.stage("features"):
                run_bucketed(clips, _features, 2, batch_size=8, device="cpu")
    assert timer.counts["features"] == 1
    stage = [s for s in P.spans() if s.name == "features"][-1]
    call = [s for s in P.spans() if s.name == "run_bucketed"][-1]
    assert stage.start_ns <= call.start_ns and call.end_ns <= stage.end_ns
    (line,) = [r.getMessage() for r in caplog.records if "counters of the trace" in r.getMessage()]
    assert "'run_bucketed.batches': 2" in line and "'run_bucketed.valid_samples': " in line


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from stutter_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
def test_spans_share_the_clock_of_the_kernels_and_copies(cuda, tmp_path):
    """On the card, the launch call of every kernel of a traced
    run_bucketed lies inside a `stp.run_bucketed.launch` range, and the
    call of every host-to-device copy inside an `h2d` range (or a launch
    range, for a table a kernel wrapper uploads), each `h2d` range holding
    one at least: one clock for the spans, the kernels and the copies."""
    from stutter_tpu_torch.config import FEATURES_149
    from stutter_tpu_torch.ops.frontend import batch_extractor_for

    fn = batch_extractor_for(FEATURES_149)
    clips = _clips()[:4]
    run_bucketed(clips, fn, 149, batch_size=2, device="cuda:0")
    with P.trace(str(tmp_path), device=cuda):
        run_bucketed(clips, fn, 149, batch_size=2, device="cuda:0")
    (path,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs
               if "trace.json" in f]
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    # the host's ranges (the trace projects each onto the device too, as a
    # gpu_user_annotation over its kernels)
    ranges = {k: [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                  if e["name"] == f"stp.run_bucketed.{k}" and e.get("cat") == "user_annotation"]
              for k in ("launch", "h2d")}
    assert len(ranges["launch"]) == len(ranges["h2d"]) == len(_batches(clips, 2))
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel" and P.BURST_KERNEL not in e["name"]}
    uploads = {e["args"].get("correlation") for e in events
               if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]}
    calls = {k: [(e["args"]["correlation"], float(e["ts"])) for e in events
                 if e.get("cat", "").startswith("cuda_")
                 and e.get("args", {}).get("correlation") in corr]
             for k, corr in (("launch", kernels), ("h2d", uploads))}
    assert {c for c, _ in calls["launch"]} == kernels and uploads
    calls = {k: [t for _, t in v] for k, v in calls.items()}

    def inside(t, *kinds):
        return any(s <= t <= e for k in kinds for s, e in ranges[k])

    assert all(inside(t, "launch") for t in calls["launch"])
    assert all(inside(t, "h2d", "launch") for t in calls["h2d"])
    assert all(any(s <= t <= e for t in calls["h2d"]) for s, e in ranges["h2d"])
