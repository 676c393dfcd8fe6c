"""Device kernels launched in the traced calls, per training step the
port's GridTrainer took in them (the draws, the forward and backward and
Adam, with each call's own set-up and prediction spread over its steps)."""


def read(trace, ctx):
    steps = trace.counters.get("steps")
    if not steps or not trace.kernels:
        return None
    return len(trace.kernels) / steps
