"""Share (%) of the dispatches' time in which no kernel runs: the union of
the benchmark's dispatch spans inside the traced window, against the
device timeline clipped to it.  Measured inside dispatches, so the
offered rate does not decide the number."""


def read(trace, ctx):
    ivs = [(s.start, s.end) for s in trace.spans_named("bench.dispatch")
           if s.start >= trace.region[0] and s.end <= trace.region[1]]
    if not ivs:
        return None
    from tracing import _merge, _union_len

    total = _union_len(_merge(sorted(ivs))) * 1e-6
    return 100.0 * (1.0 - trace.busy_s(ivs) / total)
