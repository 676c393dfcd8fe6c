"""The Transformer-XL attention's share of its roofline (%): the least time
of the attention cores' counted work (counts/parakeet.py attention: q + u
and q + v, the content, positional and value products at each recording's
own T^2 pairs, the scale, mask and softmax; bytes or operations, whichever
bound is larger), every layer, over the device time of the kernels
launched inside the benchmark's spans around models.parakeet.xl_attention
(the union of their intervals)."""

from counts.parakeet import attention_bound_s, busy_s


def read(trace, ctx):
    kernels = trace.in_spans("bench.attention")
    lengths = trace.counters.get("encoder_lengths")
    if not kernels or lengths is None or not len(lengths):
        return None
    return 100.0 * attention_bound_s(lengths, ctx.config["encoder"]) / busy_s(kernels)
