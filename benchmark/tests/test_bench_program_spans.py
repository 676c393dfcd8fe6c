"""The readers of the port's own spans and counters (program_spans.py and
the five metrics that use it): the port's "stp." ranges leave the
trace's reading as it was, the in-memory spans are laid on the trace's
clock through the `bench.gate` spans nested in them, and each reader
gives its hand-computed value on a built timeline."""

import numpy as np
import pytest

import program_spans
import run
import tracing
from stutter_tpu_torch.utils import profiling

TID = 7
SHIFT_US = 5e6  # the port's clock runs this far behind the trace's
READERS = ("idle_bucketing.corpus", "idle_copy.corpus", "idle_launch.corpus",
           "h2d_gbps.corpus", "pad_waste.corpus")


def reader(name):
    return run.load_module(run.BENCH / "metrics" / f"{name}.py", "r_" + name)


def record(name, start_us, end_us, tid=TID):
    """A span of the port's in-memory record, given on the trace's clock."""
    return profiling.SpanRecord(name, int((start_us - SHIFT_US) * 1e3),
                                int((end_us - SHIFT_US) * 1e3), tid)


def trace_of(kernels, gates, window=(0.0, 1000.0)):
    spans = [tracing.Span(tracing.REGION, *window, TID)]
    spans += [tracing.Span("bench.gate", s, e, TID) for s, e in gates]
    return tracing.Trace([tracing.Kernel(f"k{i}", s, e, 0, s - 5.0, TID)
                          for i, (s, e) in enumerate(kernels)], spans, window, 1, {})


@pytest.fixture
def port(monkeypatch):
    """Sets the port's in-memory spans and counters a reader sees."""
    def put(spans, counters):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans), raising=False)
        monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    return put


def read_all(trace):
    ctx = run.Ctx("mlp149.corpus", 1, 1.0, True, "cpu")
    names = READERS + ("device_idle.corpus",)
    return {n: reader(n).read(trace, ctx) for n in names}


def test_port_ranges_leave_the_trace_reading_unchanged():
    """A Chrome trace with the port's "stp." ranges reads the same kernels,
    spans, region, busy time and breakdown as one without them."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": TID,
                "args": args}

    base = [x("user_annotation", "bench.window", 0, 1000),
            x("user_annotation", "bench.gate", 300, 180),
            x("cuda_runtime", "cudaLaunchKernel", 310, 2, correlation=1),
            x("kernel", "gate_synth", 320, 130, correlation=1, device=0),
            x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 210, 80, device=0)]
    port = [x("user_annotation", f"stp.{n}", s, d) for n, s, d in (
        ("denoise_clips", 50, 700), ("denoise_clips.batch", 90, 600),
        ("denoise_clips.pad", 100, 100), ("denoise_clips.h2d", 200, 100),
        ("denoise_batch", 300, 200), ("denoise_clips.d2h", 500, 100))]
    plain = tracing.Trace.from_events(base, 1, {})
    both = tracing.Trace.from_events(base[:2] + port + base[2:], 1, {})
    assert both.kernels == plain.kernels and both.spans == plain.spans
    assert both.region == plain.region and both.busy_s() == plain.busy_s()
    assert both.breakdown() == plain.breakdown()
    assert [s.name for s in both.spans] == ["bench.window", "bench.gate"]


def test_readers_from_a_built_timeline(port):
    """One gate batch: a kernel gap from 120 to 320 us split across the pad
    (80 us idle), the h2d copy (100) and the launch span (20); the gate's
    kernel to 450; then 50 us idle in the launch span, 100 in d2h and 50
    in unpad, in a window of 1,000 us."""
    port([record("denoise_clips", 90, 660), record("denoise_clips.pad", 100, 200),
          record("denoise_clips.h2d", 200, 300), record("denoise_batch", 300, 500),
          record("denoise_clips.d2h", 500, 600), record("denoise_clips.unpad", 600, 650),
          record("run_bucketed.h2d", 700, 800, tid=TID + 1)],
         {"denoise_clips.h2d_bytes": 800_000, "run_bucketed.h2d_bytes": 0,
          "denoise_clips.pad_samples": 300, "run_bucketed.pad_samples": 600,
          "denoise_clips.valid_samples": 200, "run_bucketed.valid_samples": 400,
          "denoise_clips.batches": 1})
    got = read_all(trace_of([(50, 120), (320, 450)], [(300, 480)]))
    assert got["idle_bucketing.corpus"] == pytest.approx(13.0)
    assert got["idle_copy.corpus"] == pytest.approx(20.0)
    assert got["idle_launch.corpus"] == pytest.approx(7.0)
    assert got["device_idle.corpus"] == pytest.approx(80.0)
    assert got["h2d_gbps.corpus"] == pytest.approx(8.0)  # 800 kB in 100 us
    assert got["pad_waste.corpus"] == pytest.approx(1.5)


def test_the_clock_offset_is_the_least_start_gap_of_the_nested_pairs(port):
    """Two batches whose gate spans start 3 and 11 us into their launch
    spans: the port's spans come out 3 us late, whatever the clocks'
    difference."""
    port([record("denoise_batch", 100, 300), record("denoise_batch", 500, 700),
          record("denoise_clips.d2h", 300, 400)], {})
    spans, _ = program_spans.read(trace_of([], [(103, 290), (511, 650)]))
    assert [(s.name, s.start, s.end) for s in spans] == [
        ("denoise_batch", 103, 303), ("denoise_batch", 503, 703), ("denoise_clips.d2h", 303, 403)]


@pytest.mark.parametrize("case", ["no_spans_api", "no_pairs", "count_differs", "gate_outside",
                                  "no_region"])
def test_readers_read_nothing_where_the_port_spans_do_not_fit(port, monkeypatch, case):
    """A port without spans (the parent's), a trace with no gate span, a
    count of pairs that differs, a gate span that ends past its launch
    span, a trace with no window: every reader gives None."""
    port([record("denoise_batch", 100, 300), record("denoise_clips.h2d", 50, 100)],
         {"denoise_clips.h2d_bytes": 10, "denoise_clips.pad_samples": 3,
          "denoise_clips.valid_samples": 2})
    gates = {"no_pairs": [], "count_differs": [(110, 200), (400, 500)],
             "gate_outside": [(110, 320)]}.get(case, [(110, 200)])
    tr = trace_of([(120, 150)], gates)
    if case == "no_spans_api":
        monkeypatch.delattr(profiling, "spans")
    if case == "no_region":
        tr.spans = tr.spans[1:]
    got = read_all(tr)
    assert all(got[n] is None for n in READERS), got
    port([record("denoise_batch", 100, 300), record("denoise_clips.h2d", 50, 100)],
         {"denoise_clips.h2d_bytes": 10, "denoise_clips.pad_samples": 3,
          "denoise_clips.valid_samples": 2})
    assert all(v is not None for v in read_all(trace_of([(120, 150)], [(110, 200)])).values())


@pytest.mark.parametrize("seed", range(4))
def test_the_idle_shares_sum_to_at_most_the_device_idle(port, seed):
    """Random batches of sibling leaves and random kernels: the three idle
    shares are disjoint, so their sum never passes device_idle.corpus."""
    rng = np.random.RandomState(seed)
    t, spans, gates = 10.0, [], []
    owners = (("denoise_clips", ("pad", "h2d", None, "d2h", "unpad")),
              ("run_bucketed", ("pad", "h2d", "launch", "d2h", "scatter")))
    while t < 9000:
        owner, leaves = owners[rng.randint(2)]
        for leaf in leaves:
            d = rng.uniform(5, 200)
            name = f"{owner}.{leaf}" if leaf else "denoise_batch"
            spans.append(record(name, t, t + d))
            if name == "denoise_batch":
                gates.append((t, t + d * 0.9))
            t += d + rng.uniform(0, 20) * (rng.rand() < 0.5)
    starts = np.sort(rng.uniform(0, 10_000, 60))
    kernels = [(s, s + rng.uniform(1, 300)) for s in starts]
    port(spans, {})
    got = read_all(trace_of(kernels, gates, (0.0, 10_000.0)))
    parts = [got[n] for n in ("idle_bucketing.corpus", "idle_copy.corpus", "idle_launch.corpus")]
    assert all(p >= 0 for p in parts)
    assert sum(parts) <= got["device_idle.corpus"] + 1e-9
