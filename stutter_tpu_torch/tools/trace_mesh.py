"""Where the wall of a sharded path goes, read from a trace on the card.

    python -m stutter_tpu_torch.tools.trace_mesh [--out DIR]

Runs `parallel.mesh.denoise_sharded` (the spectral gate, B=64 x 3 s, its
input on the host as the corpus path has it) over a mesh of every visible
GPU and over a mesh of the first: three warm calls, the wall of 5 more
(`utils.profiling.block_and_time`), then one call under
`utils.profiling.trace` into DIR/<n>gpu/ (default traces/trace_mesh).
Prints the card's name and power limit, then one JSON line per mesh with
`summarize`'s reading of its trace: per GPU the kernels' and copies' device
ms and when each GPU's first and last event ran, and the host's CUDA
runtime calls with the most time.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

import numpy as np

B, N, LENGTH = 64, 49152, 48000


def summarize(path: str) -> dict:
    """A Chrome trace (torch.profiler's) -> its span, per device the device
    ms of kernels, host-to-device and device-to-host copies, the offsets of
    its first and last event from the first host op, and the eight CUDA
    runtime calls with the most host ms (total ms, count).  A trace from
    utils.profiling.trace opens on a burst of kernels and its synchronize
    (profile_window): everything before that synchronize ends is left
    out."""
    from stutter_tpu_torch.utils.profiling import BURST_KERNEL

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    if any(BURST_KERNEL in e.get("name", "") for e in events):
        cut = min(e["ts"] + e.get("dur", 0) for e in events
                  if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaDeviceSynchronize")
        events = [e for e in events if e["ts"] >= cut]
    t0 = min(e["ts"] for e in events if e.get("cat") == "cpu_op")
    end = max(e["ts"] + e.get("dur", 0) for e in events)
    devices: dict = {}
    runtime: dict = {}
    for e in events:
        cat, dur = e.get("cat"), e.get("dur", 0) / 1e3
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            d = devices.setdefault(str(e.get("args", {}).get("device")), {
                "kernel_ms": 0.0, "h2d_ms": 0.0, "d2h_ms": 0.0, "other_ms": 0.0,
                "first_ms": None, "last_ms": 0.0})
            name = e.get("name", "")
            key = ("kernel_ms" if cat == "kernel" else "h2d_ms" if "HtoD" in name
                   else "d2h_ms" if "DtoH" in name else "other_ms")
            d[key] += dur
            start = (e["ts"] - t0) / 1e3
            d["first_ms"] = start if d["first_ms"] is None else min(d["first_ms"], start)
            d["last_ms"] = max(d["last_ms"], start + dur)
        elif cat == "cuda_runtime":
            r = runtime.setdefault(e.get("name", ""), [0.0, 0])
            r[0] += dur
            r[1] += 1
    top = sorted(runtime.items(), key=lambda kv: -kv[1][0])[:8]
    return {"span_ms": (end - t0) / 1e3, "devices": devices,
            "runtime_top": [[k, v[0], v[1]] for k, v in top]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trace_mesh: no CUDA GPU available", file=sys.stderr)
        return 1
    from stutter_tpu_torch.parallel.mesh import denoise_sharded, make_mesh
    from stutter_tpu_torch.utils.profiling import block_and_time, trace

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("traces", "trace_mesh"))
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.RandomState(0)
    t = np.arange(N) / 16000
    audio = (0.1 * rng.randn(B, N) + 0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000, (B, 1)) * t)
             ).astype(np.float32)
    audio[:, LENGTH:] = 0
    lengths = np.full(B, LENGTH, np.int32)
    gpus = make_mesh()
    for mesh in (gpus, gpus[:1]):
        for _ in range(3):
            denoise_sharded(mesh, audio, lengths)
        wall = block_and_time(denoise_sharded, mesh, audio, lengths, iters=5)
        logdir = os.path.join(args.out, f"{len(mesh)}gpu")
        with trace(logdir, device=mesh[0]):
            denoise_sharded(mesh, audio, lengths)
        path = max(glob.glob(os.path.join(logdir, "*.pt.trace.json")), key=os.path.getmtime)
        print(json.dumps({"mesh": [str(d) for d in mesh], "wall_ms": wall * 1e3, "trace": path,
                          **summarize(path)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
