"""The relative-key attention's share of its roofline (%): the least time
of the attention cores' counted work (counts/w2v_bert.py attention: each
row's table of q . D, the bias, q k^T, softmax, the product with v; bytes
or operations, whichever bound is larger) over the clips' own frames,
every layer, over the device time of the kernels launched inside the
benchmark's spans around models.w2v_bert.relkey_attention (the union of
their intervals)."""

from counts.w2v_bert import attention_bound_s, busy_s


def read(trace, ctx):
    kernels = trace.in_spans("bench.attention")
    lengths = trace.counters.get("encoder_lengths")
    if not kernels or lengths is None or not len(lengths):
        return None
    return 100.0 * attention_bound_s(lengths, ctx.config["encoder"]) / busy_s(kernels)
