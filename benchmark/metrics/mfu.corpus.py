"""The passes' counted operations (the gate over every clip, the features
of every raw and clean clip: counts/work.py) over the traced window's
wall time and the FP32 peak of the run's devices, in %."""

from counts.peaks import FP32_FLOPS
from counts.work import features_work, gate_work


def read(trace, ctx):
    g, f = trace.counters.get("gate_lengths"), trace.counters.get("frontend_lengths")
    if g is None or f is None or trace.window_s <= 0:
        return None
    ops = gate_work(g, ctx.config)[0] + features_work(f, ctx.config)[0]
    return 100.0 * ops / trace.window_s / (FP32_FLOPS * trace.devices)
