"""Device kernels launched inside the traced window, per request whose
dispatch started in it (the profiler's kernels; every launch of the
request's path: resampling in the handler, the dispatch's gate, frames
and heads)."""


def read(trace, ctx):
    clips = trace.counters.get("clips_started") or 0
    return len(trace.kernels) / clips if clips else None
