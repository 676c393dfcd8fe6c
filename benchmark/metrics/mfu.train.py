"""The training steps' counted operations (6 a parameter a row:
counts/work.py train_step_ops, from the layer widths) over the traced
window's wall time and the FP32 peak of the run's devices, in %."""

from counts.peaks import FP32_FLOPS
from counts.work import train_step_ops


def read(trace, ctx):
    steps, rows, dims = (trace.counters.get(k) for k in ("steps", "rows_per_step", "dims"))
    if not steps or trace.window_s <= 0:
        return None
    ops = steps * train_step_ops(dims, rows)
    return 100.0 * ops / trace.window_s / (FP32_FLOPS * trace.devices)
