"""Mean clips per EnsemblePredictor.predict_batch dispatch (the
micro-batcher's batch size), counted by the benchmark's wrapper around the
call over the dispatches inside the traced window."""

import statistics


def read(trace, ctx):
    clips = trace.counters.get("dispatch_clips") or []
    return statistics.fmean(clips) if clips else None
