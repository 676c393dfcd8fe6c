"""The gate's share of its roofline (%): the least time of the gate's work
over the clips it gated in the traced window (counts/work.py gate_work:
the algorithm's shapes, the clips' own lengths), over the device time of
every kernel launched inside the benchmark's spans around
denoise.denoise_batch."""

from counts.work import bound_s, gate_work


def read(trace, ctx):
    kernels = trace.in_spans("bench.gate")
    lengths = trace.counters.get("gate_lengths")
    if not kernels or lengths is None or not len(lengths):
        return None
    device_s = sum(k.end - k.start for k in kernels) * 1e-6
    return 100.0 * bound_s(*gate_work(lengths, ctx.config)) / device_s
