"""Whether torch.profiler keeps every device event of a window as a
process runs: every round profiles three B=64 x 3 s spectral-gate calls
(denoise_batch) in a plain window, in one padded with host sleep at each
end, and in utils.profiling.profile_window (the sleeps and a burst of
tiny kernels first), and prints one JSON line a round: per window the
device kernels and the host's kernel launches (the burst's left out), the
burst's kernels kept, the least and largest gap from a launch to its
kernel's start, and the first and last time (from the window's first
launch) of a launch whose kernel the window lost.  Between rounds the
gate runs without the profiler.

    python -m stutter_tpu_torch.tools.profile_drift [--rounds 14] [--every 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

KINDS = ("plain", "padded", "window")
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def window(fn, kind: str) -> dict:
    """One window over three calls of `fn`, `plain`, `padded` (host sleep
    at each end) or `window` (utils.profiling.profile_window: the sleeps
    and a burst of tiny kernels first): its device kernels and the host's
    kernel launches, the burst's left out, the burst's kernels it kept,
    the launch-to-kernel gaps of the pairs it holds, and where the
    launches whose kernel it lost were made."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stutter_tpu_torch.utils.profiling import (
        BURST_KERNEL, WINDOW_BURST, WINDOW_PAD_S, _kernels_and_launches, profile_window)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    pad = WINDOW_PAD_S if kind == "padded" else 0.0
    with (profile_window(acts) if kind == "window" else profile(activities=acts)) as prof:
        time.sleep(pad)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    burst = WINDOW_BURST if kind == "window" else 0
    kernels, launches = _kernels_and_launches(prof.events())
    starts, launched, burst_kept = {}, [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if BURST_KERNEL in e.name():
                burst_kept += 1
            else:
                starts[e.correlation_id()] = e.start_ns()
        elif e.name() in _LAUNCHES:
            launched.append((e.start_ns(), e.correlation_id()))
    launched = sorted(launched)[burst:]  # the burst's launches come first
    gaps = [(starts[c] - t) / 1e6 for t, c in launched if c in starts]
    first = launched[0][0] if launched else 0
    lost = [(t - first) / 1e6 for t, c in launched if c not in starts]
    return {"kernels": kernels, "launches": launches - burst, "burst_kept": burst_kept,
            "gap_ms_min": min(gaps) if gaps else None, "gap_ms_max": max(gaps) if gaps else None,
            "lost_at_ms": [lost[0], lost[-1]] if lost else None,
            "window_ms": (launched[-1][0] - first) / 1e6 if launched else 0.0}


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=14)
    ap.add_argument("--every", type=float, default=20.0, help="seconds between rounds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_drift: no CUDA GPU available", file=sys.stderr)
        return 1
    from stutter_tpu_torch.config import DenoiseConfig
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    audio = torch.from_numpy(
        np.random.RandomState(0).randn(64, 49152).astype(np.float32) * 0.1).to(dev)
    lengths = torch.full((64,), 48000, dtype=torch.int32, device=dev)

    def fn():
        return denoise_batch(audio, lengths, DenoiseConfig())

    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(args.rounds):
        print(json.dumps({"t_s": time.time() - t0, **{k: window(fn, k) for k in KINDS},
                          "card": card}), flush=True)
        end = time.time() + args.every
        while time.time() < end:
            fn()
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
