"""The gated-bias attention's share of its roofline (%): the least time of
the attention cores' counted work (counts/wavlm.py attention: the gate,
the bias gathered and gated, q k^T, softmax, the product with v; bytes or
operations, whichever bound is larger) over the clips' own frames, every
layer, over the device time of the kernels launched inside the
benchmark's spans around models.wavlm.gated_attention (the union of their
intervals: counts/wavlm.py busy_s)."""

from counts.wavlm import attention_bound_s, busy_s


def read(trace, ctx):
    kernels = trace.in_spans("bench.attention")
    lengths = trace.counters.get("encoder_lengths")
    if not kernels or lengths is None or not len(lengths):
        return None
    device_s = busy_s(kernels)
    return 100.0 * attention_bound_s(lengths, ctx.config["encoder"]) / device_s
