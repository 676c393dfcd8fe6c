"""The device every public entry point of the port runs on.

Entry points default to `cuda` and raise when there is no GPU; a CPU run
asks for it with `device="cpu"`.  Nothing falls back to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """The torch device for `device`; raises when CUDA is asked for and
    there is no GPU (no silent CPU fallback).  Turns TF32 off, so products
    on the card run in full FP32 like the parity bounds assume."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA GPU is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    return dev
