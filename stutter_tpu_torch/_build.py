"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` is compiled on first use into
`stutter_tpu_torch/_build/lib<name>-<hash>.so`, keyed by a hash of the
sources and flags, so a fresh checkout builds everything it needs and an
edited source never reuses a stale library.  The sources have a plain C
interface (no PyTorch headers), which keeps a build to seconds.  Every C
entry point takes its pointers and the stream as `void*`, launches on that
stream without synchronising, and returns `cudaGetLastError()`;
`launch(fn, t, ...)` calls one under its tensor's device and stream, and
`check(rc, what)` turns a non-zero code into an exception.

No `--use_fast_math`: it swaps `log10f`, `expf`, `sqrtf` and division for
approximations, and the tuning bin must match the plain version exactly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: the name plus a hash of its sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its library is missing, then load it.

    nvcc's report (registers, shared memory, spills per kernel) is kept
    beside the library as `<lib>.log`."""
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a unique name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {name}.cu (rc={res.returncode}):\n{res.stderr}"
            )
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


@lru_cache(maxsize=None)
def bind(name: str, fn: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """ctypes function `fn` of library `name` with signature
    (void* x n_ptrs, int x n_ints, float x n_floats, void* stream) -> int."""
    f = getattr(load_library(name), fn)
    f.argtypes = (
        [ctypes.c_void_p] * n_ptrs
        + [ctypes.c_int] * n_ints
        + [ctypes.c_float] * n_floats
        + [ctypes.c_void_p]
    )
    f.restype = ctypes.c_int
    return f


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def launch(fn, t, *args) -> int:
    """fn(*args, stream) with `t`'s device current, on that device's current
    stream -> fn's CUDA error code.

    `cudaFuncSetAttribute` and a launch act on the calling thread's current
    device, whatever stream they are given: a tensor on another device than
    the current one would get its attributes set on the wrong device and a
    stream of another device."""
    import torch

    with torch.cuda.device(t.device):
        return fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
