"""The FastConformer conv modules' share of their roofline (%): each op's
least time -- the larger of its bytes over 3.35 TB/s and its FP32
operations over 67 TFLOP/s (counts/parakeet.py conv_module: the pointwise
conv to 2 x hidden, the GLU, the centred depthwise conv with BatchNorm,
SiLU, the pointwise conv back) -- summed over the ops, the layers and the
recordings' own frames, over the device time of the kernels launched
inside the benchmark's spans around models.parakeet.conv_module (the
union of their intervals)."""

from counts.parakeet import busy_s, conv_module_bound_s


def read(trace, ctx):
    kernels = trace.in_spans("bench.conv_module")
    lengths = trace.counters.get("encoder_lengths")
    if not kernels or lengths is None or not len(lengths):
        return None
    return 100.0 * conv_module_bound_s(lengths, ctx.config["encoder"]) / busy_s(kernels)
