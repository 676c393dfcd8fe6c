"""Median host milliseconds of one EnsemblePredictor.predict_batch
dispatch (the host glue, the device pass and the [M, B, C] copy back that
ends it), by the host clock in the benchmark's wrapper, over the
dispatches inside the traced window."""

import statistics


def read(trace, ctx):
    times = trace.counters.get("dispatch_s") or []
    return statistics.median(times) * 1e3 if times else None
