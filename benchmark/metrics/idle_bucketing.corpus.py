"""Share (%) of the traced window in which device 0 runs no kernel while
the host pads clips into a batch or crops and scatters its rows back: the
port's `denoise_clips.pad`, `.unpad`, `run_bucketed.pad` and `.scatter`
spans (program_spans.py)."""

import program_spans


def read(trace, ctx):
    return program_spans.idle_share(trace, ("pad", "unpad", "scatter"))
