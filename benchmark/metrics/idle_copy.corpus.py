"""Share (%) of the traced window in which device 0 runs no kernel while
the host copies a batch to the card or reads its output back: the port's
`denoise_clips.h2d`, `.d2h`, `run_bucketed.h2d` and `.d2h` spans (a copy
is no kernel; program_spans.py)."""

import program_spans


def read(trace, ctx):
    return program_spans.idle_share(trace, ("h2d", "d2h"))
