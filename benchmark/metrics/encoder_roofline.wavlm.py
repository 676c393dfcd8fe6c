"""The encoder's share of its roofline (%): the least time of its counted
work over the clips it embedded in the traced window (counts/wavlm.py
encoder_bound_s: the published shapes, each clip's own frames), over the
device time of the kernels launched inside the benchmark's spans around
models.wavlm.encode (the union of their intervals: counts/wavlm.py
busy_s)."""

from counts.wavlm import encoder_bound_s, busy_s


def read(trace, ctx):
    kernels = trace.in_spans("bench.encoder")
    lengths = trace.counters.get("encoder_lengths")
    if not kernels or lengths is None or not len(lengths):
        return None
    device_s = busy_s(kernels)
    return 100.0 * encoder_bound_s(lengths, ctx.config["encoder"]) / device_s
