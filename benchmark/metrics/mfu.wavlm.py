"""The pass's counted operations (the gate over every clip: counts/work.py;
the encoder over every clip it embedded, at the clips' own lengths, and
the seeded MLP over every row: counts/wavlm.py) over the traced window's
wall time and the FP32 peak of the run's devices, in %."""

from counts.peaks import FP32_FLOPS
from counts.wavlm import encoder_ops, mlp_ops
from counts.work import gate_work


def read(trace, ctx):
    g, e = trace.counters.get("gate_lengths"), trace.counters.get("encoder_lengths")
    if g is None or e is None or trace.window_s <= 0:
        return None
    m = ctx.config["mlp"]
    ops = (gate_work(g, ctx.config)[0] + encoder_ops(e, ctx.config["encoder"])
           + mlp_ops(trace.counters.get("mlp_rows", 0), m["dims"], m["n_seeds"]))
    return 100.0 * ops / trace.window_s / (FP32_FLOPS * trace.devices)
