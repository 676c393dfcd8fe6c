"""The Parakeet encoder's share of its roofline (%): the least time of its
counted work over the recordings it embedded in the traced window
(counts/parakeet.py encoder_bound_s: the log-mel, the stem and the
published shapes, each recording's own frames), over the device time of
the kernels launched inside the benchmark's spans around
models.parakeet.encode (the union of their intervals: counts/wavlm.py
busy_s)."""

from counts.parakeet import busy_s, encoder_bound_s


def read(trace, ctx):
    kernels = trace.in_spans("bench.encoder")
    lengths = trace.counters.get("encoder_lengths")
    if not kernels or lengths is None or not len(lengths):
        return None
    return 100.0 * encoder_bound_s(lengths, ctx.config["encoder"]) / busy_s(kernels)
