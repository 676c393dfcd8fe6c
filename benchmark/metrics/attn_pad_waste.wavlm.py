"""Attention pairs the encoder computed over those its clips need (a
ratio): the port's counter `wavlm.attn_pairs_sent` (B x T_pad^2 of every
encoded batch) over `wavlm.attn_pairs_valid` (each clip's T_i^2), both
counted inside the traced window (program_spans.py)."""

import program_spans


def read(trace, ctx):
    got = program_spans.read(trace)
    if got is None:
        return None
    valid = got[1].get("wavlm.attn_pairs_valid", 0)
    return got[1].get("wavlm.attn_pairs_sent", 0) / valid if valid else None
