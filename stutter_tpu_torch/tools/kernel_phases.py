"""Where the FFT kernels spend their time, phase by phase, on the card.

    python -m stutter_tpu_torch.tools.kernel_phases

Builds variants of csrc/spectral_gate.cu, csrc/spectromel.cu and
csrc/chroma_stats.cu with one phase switched off (a -D flag guards each
phase's loop or call; the variant's output is wrong and only its time
counts), runs each at the batch shapes -- the gate at B=64 x 3 s,
spectromel's stats mode and chroma_stats at B=256 x 3 s -- and prints one
JSON line per variant: each kernel's device time per call from
torch.profiler and the card's name and power limit.  A phase's cost is the
full build's time less the variant's.  The tail's phases: `tail_load`
(reading the candidates into shared memory), `tail_select` (the four radix
passes), `tail_histogram`; chroma_stats's: `chroma_load` (the power loads),
`chroma_project` (11 of the 12 channels' FMAs and filterbank reads),
`chroma_reduce` (the leader's mean and variance).  The phases are found
by text in the sources: when a source changes, a phase whose text is gone
stops the run, and its pattern here is brought up to date.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

# source -> phase -> (text in the source, the same text guarded by OFF_<phase>)
PHASES = {
    "spectral_gate.cu": {
        "analysis_fft": ("  fft_windowed<M>(buf, tf, tw, span, hop, win);\n  float* out = mag",
                         "  if (!OFF) fft_windowed<M>(buf, tf, tw, span, hop, win);\n"
                         "  float* out = mag"),
        "analysis_split": ("i < tf * K; i += THREADS) {\n    const int f = i / K, k = i - f * K;\n"
                           "    const float2* z = buf + f * MP;\n    const float2 x = split(",
                           "i < (OFF ? 0 : tf * K); i += THREADS) {\n"
                           "    const int f = i / K, k = i - f * K;\n"
                           "    const float2* z = buf + f * MP;\n    const float2 x = split("),
        "iir_load": ("    cp_async4(X + i, mag", "    if (!OFF) cp_async4(X + i, mag"),
        "iir_scan": ("  for (int t = ts0; t < te; ++t) {\n    const float x = X[t * KB + c];",
                     "  for (int t = ts0; t < (OFF ? ts0 : te); ++t) {\n"
                     "    const float x = X[t * KB + c];"),
        "iir_time_taps": ("    for (int j = 0; j < kt; ++j) {\n      const int u = t + j - pt;",
                          "    for (int j = 0; j < (OFF ? 0 : kt); ++j) {\n"
                          "      const int u = t + j - pt;"),
        "synth_mask_load": ("  for (int i = threadIdx.x; i < nf * lay.row; i += THREADS) {",
                            "  for (int i = threadIdx.x; i < (OFF ? 0 : nf * lay.row); i += THREADS) {"),
        "synth_freq_taps": ("  for (int i = threadIdx.x; i < nf * G4; i += THREADS) {",
                            "  for (int i = threadIdx.x; i < (OFF ? 0 : nf * G4); i += THREADS) {"),
        "synth_fft": ("  fft_windowed<M>(buf, nf, tw, span, hop, win);",
                      "  if (!OFF) fft_windowed<M>(buf, nf, tw, span, hop, win);"),
        "synth_pairs": ("  for (int i = threadIdx.x; i < nf * PAIRS; i += THREADS) {",
                        "  for (int i = threadIdx.x; i < (OFF ? 0 : nf * PAIRS); i += THREADS) {"),
        "synth_ifft": ("  __syncthreads();\n  fft<M>(buf, nf, tw);",
                       "  __syncthreads();\n  if (!OFF) fft<M>(buf, nf, tw);"),
        "synth_overlap_add": ("  for (int i = threadIdx.x; i < rt * hop; i += THREADS) {",
                              "  for (int i = threadIdx.x; i < (OFF ? 0 : rt * hop); i += THREADS) {"),
    },
    "spectromel.cu": {
        "frames_fft": ("  fft_windowed<M>(buf, tf, tw, span, hop, win);\n\n  float* out = power",
                       "  if (!OFF) fft_windowed<M>(buf, tf, tw, span, hop, win);\n\n"
                       "  float* out = power"),
        "frames_candidates": ("  for (int f = warp; f < tf; f += THREADS / 32) {\n    const size_t row",
                              "  for (int f = warp; f < (OFF ? 0 : tf); f += THREADS / 32) {\n"
                              "    const size_t row"),
        "frames_mel": ("i < tf * n_mels; i += THREADS", "i < (OFF ? 0 : tf * n_mels); i += THREADS"),
        "tail_load": ("i0 < n; i0 += 4 * TAIL_THREADS", "i0 < (OFF ? 0 : n); i0 += 4 * TAIL_THREADS"),
        "tail_select": ("for (int shift = 24; shift >= 0; shift -= 8)",
                        "for (int shift = 24; shift >= (OFF ? 32 : 0); shift -= 8)"),
        "tail_histogram": ("i < n; i += TAIL_THREADS) {\n    unsigned k;\n    int d;\n"
                           "    c.at(i, k, d);\n    if (from_key",
                           "i < (OFF ? 0 : n); i += TAIL_THREADS) {\n    unsigned k;\n    int d;\n"
                           "    c.at(i, k, d);\n    if (from_key"),
    },
    "chroma_stats.cu": {
        "chroma_load": ("  return 4 * a < w.lim ? __ldg(p4 + a)", "  return !OFF && 4 * a < w.lim ? __ldg(p4 + a)"),
        "chroma_project": ("      for (int c = 0; c < NCH; ++c) {\n        const float4 f =",
                           "      for (int c = 0; c < (OFF ? 1 : NCH); ++c) {\n        const float4 f ="),
        "chroma_reduce": ("  for (int c = warp; c < NCH; c += NWARPS) {",
                          "  for (int c = warp; c < (OFF ? 0 : NCH); c += NWARPS) {"),
    },
}


def build_variants(build_dir: Path) -> dict:
    """{(source, phase or "none"): ctypes library}, built in parallel."""
    from stutter_tpu_torch import _build

    jobs = []
    for src, phases in PHASES.items():
        text = (_build.CSRC / src).read_text()
        for phase, (old, new) in phases.items():
            if old not in text:
                raise SystemExit(f"{src}: the text of phase {phase} is gone; update PHASES")
            guarded = new.replace("OFF", f"OFF_{phase.upper()}")
            text = text.replace(old, guarded)
        flags = "".join(f"#ifndef OFF_{p.upper()}\n#define OFF_{p.upper()} 0\n#endif\n"
                        for p in phases)
        path = build_dir / src
        path.write_text(flags + text)
        jobs += [(src, p, path) for p in ("none", *phases)]

    def build(job):
        src, phase, path = job
        so = build_dir / f"lib{path.stem}-{phase}.so"
        flags = [] if phase == "none" else [f"-DOFF_{phase.upper()}=1"]
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), *flags,
                              "-o", str(so), str(path)], capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"nvcc failed for {src} without {phase}:\n{res.stderr[-2000:]}")
        return (src, phase), ctypes.CDLL(str(so))

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(pool.map(build, jobs))


def kernel_times(run, reps: int = 10) -> dict:
    """Device ms per call of each kernel that `run` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0].split(" ")[-1]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def gate_runner(lib, dev):
    """The gate launcher at B=64 x 3 s with the wrapper's tables and tiles."""
    import numpy as np
    import torch

    from stutter_tpu_torch import _build
    from stutter_tpu_torch.config import DenoiseConfig
    from stutter_tpu_torch.denoise import PAD
    from stutter_tpu_torch.ops import consts
    from stutter_tpu_torch.ops import spectral_gate as sg

    cfg, B, N = DenoiseConfig(), 64, 49152
    C = -(-(N + 2 * PAD) // 256) + 4
    T, K = C - 3, 513
    chunks = torch.from_numpy(
        np.random.RandomState(0).randn(B, C, 256).astype(np.float32) * 0.1).to(dev)
    win, tw, f_taps, t_taps = sg._device_tables(str(dev), 1024, cfg)
    winv = sg._device_winv(str(dev), T, 1024, 256)
    mag, mk = torch.empty(B, T, K, device=dev), torch.empty(B, T, K, device=dev)
    out = torch.empty(B, C, 256, device=dev)
    tiles = (consts.frame_tile(1024, T, B), consts.iir_bin_tile(T, K, B),
             consts.synth_row_tile(C, B, 1024, 256, f_taps.numel()))
    fn = lib.spectral_gate_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float] * 5 + [
        ctypes.c_void_p]
    ptrs = [t.data_ptr() for t in (chunks, win, tw, f_taps, t_taps, winv, mag, mk, out)]
    b = consts.iir_coefficient(cfg)
    stream = _build.stream_of(chunks)
    return lambda: fn(*ptrs, B, C, 1024, 256, f_taps.numel(), t_taps.numel(), *tiles, b, 1 - b,
                      cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary,
                      cfg.prop_decrease, stream)


def spectromel_runner(lib, dev):
    """The stats-mode launcher at B=256 x 3 s, 48000-sample clips of tones
    in noise (the shapes and kind of input chip_smoke.py measures)."""
    import numpy as np
    import torch

    from stutter_tpu_torch import _build
    from stutter_tpu_torch.ops import consts
    from stutter_tpu_torch.ops import spectromel as sm

    B, N, n_fft, hop = 256, 49152, 2048, 512
    T, K = N // hop + 1, n_fft // 2 + 1
    rng = np.random.RandomState(0)
    t = np.arange(N) / 16000
    audio = (0.1 * rng.randn(B, N) + 0.4 * np.sin(2 * np.pi * rng.uniform(80, 3500, (B, 1)) * t))
    audio[:, 48000:] = 0
    audio = torch.from_numpy(audio.astype(np.float32)).to(dev)
    lengths = torch.full((B,), 48000, dtype=torch.int32, device=dev)
    lo, hi = consts.band_range(16000, n_fft, consts.PIP_FMIN, consts.PIP_FMAX)
    tables = sm._device_tables(str(dev), 16000, n_fft, 128, 20, 12)
    cap = (hi - lo + 1) // 2
    # counts start at 0: the variant without candidates writes none
    outs = [torch.empty(B, T, K, device=dev), torch.empty(B, T, 128, device=dev),
            torch.empty(B, T, cap, dtype=torch.int32, device=dev),
            torch.empty(B, T, cap, dtype=torch.uint8, device=dev),
            torch.zeros(B, T, dtype=torch.int32, device=dev),
            torch.empty(B, 6, 20, device=dev), torch.empty(B, dtype=torch.int32, device=dev)]
    fn = lib.spectromel_launch
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    ptrs = [x.data_ptr() for x in (audio, lengths, *tables, *outs)]
    stream = _build.stream_of(audio)
    return lambda: fn(*ptrs, B, N, n_fft, hop, consts.frame_tile(n_fft, T, B), 128, 20, lo, hi,
                      12 / math.log(2.0), stream)


def chroma_runner(lib, dev):
    """The chroma_stats launcher at B=256 x 3 s (T = 97, 94 valid frames)
    on a power-like input, with the wrapper's table and cluster size."""
    import numpy as np
    import torch

    from stutter_tpu_torch import _build
    from stutter_tpu_torch.ops import chroma_stats as cs

    B, T, K = 256, 97, 1025
    rng = np.random.RandomState(1)
    power = torch.from_numpy((rng.rand(B, T, K) ** 4).astype(np.float32)).to(dev)
    tb = torch.from_numpy(rng.randint(0, 100, B).astype(np.int32)).to(dev)
    nv = torch.full((B,), 94, dtype=torch.int32, device=dev)
    table = cs._device_table(str(dev), 16000, 2048, 12)
    out = torch.empty(B, 24, device=dev)
    fn = lib.chroma_stats_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    ptrs = [x.data_ptr() for x in (power, tb, nv, table, out)]
    stream = _build.stream_of(power)
    return lambda: fn(*ptrs, B, T, K, table.shape[1], table.shape[0] // 12,
                      cs.cluster_size(B, T), stream)


RUNNERS = {"spectral_gate.cu": gate_runner, "spectromel.cu": spectromel_runner,
           "chroma_stats.cu": chroma_runner}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA GPU available", file=sys.stderr)
        return 1
    from stutter_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        libs = build_variants(Path(d))
        for (src, phase), lib in libs.items():
            run = RUNNERS[src](lib, dev)
            times = kernel_times(lambda: _check(run()))
            print(json.dumps({"source": src, "off": phase, "ms": times, "card": card}), flush=True)
    return 0


def _check(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


if __name__ == "__main__":
    sys.exit(main())
