"""Samples sent to the card over the clips' own samples (a ratio): the
port's `*.pad_samples` counters (rows x bucket of every padded batch)
over its `*.valid_samples` (each clip's length, cut to its bucket), of
the gate's and the features' batches together (program_spans.py)."""

import program_spans


def read(trace, ctx):
    got = program_spans.read(trace)
    if got is None:
        return None
    valid = program_spans.counted(got[1], "valid_samples")
    return program_spans.counted(got[1], "pad_samples") / valid if valid else None
