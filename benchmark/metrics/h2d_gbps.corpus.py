"""The copy layer's rate (GB/s): the bytes the port counted as uploaded
(`*.h2d_bytes`: each batch and its lengths) over the seconds its host
thread spent in the port's `*.h2d` spans (program_spans.py)."""

import program_spans


def read(trace, ctx):
    got = program_spans.read(trace)
    if got is None:
        return None
    spans, counters = got
    seconds = sum(s.end - s.start for s in spans if program_spans.leaf(s.name) == "h2d") * 1e-6
    nbytes = program_spans.counted(counters, "h2d_bytes")
    return nbytes / seconds * 1e-9 if seconds > 0 and nbytes else None
