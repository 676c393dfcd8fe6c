"""Share (%) of the traced window in which no kernel runs, averaged over
the run's devices."""


def read(trace, ctx):
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s) if trace.window_s > 0 else None
