"""The 149-dim front end's share of its roofline (%): the least time of
the features' work over the clips featurized in the traced window
(counts/work.py features_work), over the device time of every kernel
launched inside the benchmark's spans around
ops.frontend.extract_features_149_batch."""

from counts.work import bound_s, features_work


def read(trace, ctx):
    kernels = trace.in_spans("bench.frontend")
    lengths = trace.counters.get("frontend_lengths")
    if not kernels or lengths is None or not len(lengths):
        return None
    device_s = sum(k.end - k.start for k in kernels) * 1e-6
    return 100.0 * bound_s(*features_work(lengths, ctx.config)) / device_s
