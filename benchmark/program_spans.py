"""The port's own spans and counters, laid on a traced window's clock.

While a profiler records, the port opens a span at each layer boundary of
its corpus path (`stutter_tpu_torch.utils.profiling.span`: a
record_function range "stp.<name>") and counts the work done there
(`count`).  `Trace` keeps only the benchmark's own spans ("bench."), so the
readers take the port's from the port's in-memory record of them
(`profiling.spans()`, on the host's monotonic clock) and its counters from
`profiling.counters()`, both in the run's own process, where the one
profiled window is the only time they recorded.

The two clocks differ by a constant.  Every `bench.gate` span (traffic/
corpus_pass.py's, around the gate's batch call) lies inside the port's
`denoise_batch` span of the same batch, so the k-th of each pair up, and
the constant is the least gap between their starts: the port's spans
come out late by at most the time from a `denoise_batch` span's start to
its gate span's (one call).  A pairing the nesting refutes reads nothing.
"""

from __future__ import annotations

import tracing

GATE, ANCHOR = "bench.gate", "denoise_batch"


def read(trace) -> tuple[list, dict] | None:
    """The port's spans as `tracing.Span`s on the trace's clock, on the
    window's host thread, and its counters; None where the port records
    none (a program without spans) or they do not pair with the trace."""
    try:
        from stutter_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "spans") and hasattr(profiling, "counters")):
        return None
    region = [s for s in trace.spans if s.name == tracing.REGION]
    if len(region) != 1:
        return None
    tid = region[0].tid
    own = [s for s in profiling.spans() if s.tid == tid]
    gates = sorted((s for s in trace.spans if s.name == GATE and s.tid == tid),
                   key=lambda s: s.start)
    anchors = sorted((s for s in own if s.name == ANCHOR), key=lambda s: s.start_ns)
    if not gates or len(gates) != len(anchors):
        return None
    pairs = list(zip(gates, anchors))
    offset = min(g.start - a.start_ns * 1e-3 for g, a in pairs)
    if any(g.end > a.end_ns * 1e-3 + offset for g, a in pairs):
        return None
    return ([tracing.Span(s.name, s.start_ns * 1e-3 + offset, s.end_ns * 1e-3 + offset, tid)
             for s in own], profiling.counters())


def leaf(name: str) -> str:
    """A span's last part: "run_bucketed.h2d" -> "h2d", "denoise_batch"
    -> itself."""
    return name.rsplit(".", 1)[-1]


def idle_share(trace, leaves: tuple) -> float | None:
    """Share (%) of the traced window in which device 0 runs no kernel
    while the window's host thread is inside a port span whose last part
    is in `leaves`."""
    got = read(trace)
    if got is None or trace.window_s <= 0:
        return None
    r0, r1 = trace.region
    inside = tracing._merge(sorted((max(s.start, r0), min(s.end, r1)) for s in got[0]
                                   if leaf(s.name) in leaves and s.end > r0 and s.start < r1))
    busy = tracing._merge(sorted((k.start, k.end) for k in trace.kernels if k.device == 0))
    idle = tracing._union_len(inside) - tracing._union_len(tracing._clip(busy, inside))
    return 100.0 * idle * 1e-6 / trace.window_s


def counted(counters: dict, counter: str) -> int:
    """A counter summed over its owners ("<owner>.<counter>")."""
    return sum(v for k, v in counters.items() if k.rsplit(".", 1)[-1] == counter)
