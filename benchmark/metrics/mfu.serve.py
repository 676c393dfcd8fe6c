"""The vote's counted operations (gate, frames, the five heads, from the
clips' shapes: counts/work.py vote_ops) over the summed wall time of the
dispatches inside the traced window and the FP32 peak, in %."""

from counts.peaks import FP32_FLOPS
from counts.work import vote_ops


def read(trace, ctx):
    lengths = [n for d in trace.counters.get("dispatch_lengths") or [] for n in d]
    wall = sum(trace.counters.get("dispatch_s") or [])
    if not lengths or wall <= 0:
        return None
    return 100.0 * vote_ops(lengths, ctx.config) / wall / FP32_FLOPS
