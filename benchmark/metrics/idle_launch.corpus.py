"""Share (%) of the traced window in which device 0 runs no kernel while
the host launches a batch's kernels: the port's `denoise_batch` and
`run_bucketed.launch` spans (program_spans.py)."""

import program_spans


def read(trace, ctx):
    return program_spans.idle_share(trace, ("denoise_batch", "launch"))
