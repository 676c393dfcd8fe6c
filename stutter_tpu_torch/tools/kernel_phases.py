"""Where the FFT kernels spend their time, phase by phase, on the card.

    python -m stutter_tpu_torch.tools.kernel_phases
    python -m stutter_tpu_torch.tools.kernel_phases --stats
    python -m stutter_tpu_torch.tools.kernel_phases --attention
    python -m stutter_tpu_torch.tools.kernel_phases --conv
    python -m stutter_tpu_torch.tools.kernel_phases --stats-plans
    python -m stutter_tpu_torch.tools.kernel_phases --stats-timeline

Builds variants of csrc/spectral_gate.cu, csrc/spectromel.cu and
csrc/chroma_stats.cu with one phase switched off (a -D flag guards each
phase's loop or call; the variant's output is wrong and only its time
counts), runs each at the batch shapes -- the gate at B=64 x 3 s,
spectromel's stats mode and chroma_stats at B=256 x 3 s -- and prints one
JSON line per variant: each kernel's device time per call from
torch.profiler and the card's name and power limit.  A phase's cost is the
full build's time less the variant's.  The tail's phases: `tail_load`
(reading the candidates into shared memory), `tail_select` (the four radix
passes), `tail_histogram`; the stats launch's: `stats_load` (the bulk
copies of the mel rows), `stats_dct` (the DCT), `stats_deltas` (the
SavGol rows), `stats_reduce` (the means and stds);
chroma_stats's: `chroma_load` (the power loads), `chroma_project` (11 of
the 12 channels' FMAs and filterbank reads), `chroma_reduce` (the leader's
mean and variance).  The phases are found
by text in the sources: when a source changes, a phase whose text is gone
stops the run, and its pattern here is brought up to date.

With --attention it times each mode of csrc/gated_attention.cu
(ATTENTION_MODES: WavLM's gated attention core, models/wavlm
.gated_attention, on padded [B, T] rows, then W2V-BERT 2.0's relative-key
one, models/w2v_bert.relkey_attention, on the same clips' rows packed) at
ATTENTION_SHAPES -- the corpus cells' fitted batches of 64 at T_pad 45,
136 and 440, 9 rows at 440, one request at 511, ragged lengths and a clip
of no frames -- beside its bound (the benchmark's counted FP32 operations
over 67 TFLOP/s), the plain version and F.scaled_dot_product_attention on
the bias and mask the plain version builds (a yardstick the port never
calls), with the kernels each call launched and the device memory it
allocated: one JSON line a mode and shape (`"mode"`); Parakeet's
Transformer-XL mode at head width 128 (models/parakeet.xl_attention, packed
rows) at XL_SHAPES, the long-form cell's fitted batches of 8 and one
recording of 1,856 frames.  With --conv it times csrc/glu_depthwise.cu
(CONV_MODES: models/w2v_bert.glu_depthwise, the conv module's GLU and
causal 31-tap depthwise conv on packed rows, at ATTENTION_SHAPES' clips;
models/parakeet.glu_conv_silu, the GLU, the centred 9-tap conv with
BatchNorm folded in and SiLU, at XL_SHAPES' clips) beside its bound (12
bytes a value over 3.35 TB/s), its plain version and the padded path's
GLU and F.conv1d between two transposes (conv1d_call, a yardstick the
port does not call): one JSON line a mode and shape.

With --stats it instead times each kernel of the stats-mode wrapper at
B=256 x 3 s, at the MLP stream's [64, 48128] and at one 3 s request (only
the wrapper is called: `PYTHONPATH=<other tree> python
stutter_tpu_torch/tools/kernel_phases.py --stats` times another tree's
kernels); with --stats-plans, the stats launch alone at those shapes at
each cluster size, beside the size `ops.spectromel.stats_plan` picks; with
--stats-timeline, the SM cycles of each of its stages (clock64 stamps in a
variant of the source).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
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
        "stats_load": ("    const int ncopy = nld;", "    const int ncopy = OFF ? 0 : nld;"),
        "stats_dct": ("item < tiles * chunks; item += STATS_WARPS) {",
                      "item < (OFF ? 0 : tiles * chunks); item += STATS_WARPS) {"),
        "stats_deltas": ("  for (int i = tid; i < nvr * C; i += STATS_THREADS) {\n    const int r = i / C",
                         "  for (int i = tid; i < (OFF ? 0 : nvr * C); i += STATS_THREADS) {\n"
                         "    const int r = i / C"),
        "stats_reduce": ("col0 < NC; col0 += STATS_COLS * nw) {",
                         "col0 < (OFF ? 0 : NC); col0 += STATS_COLS * nw) {"),
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


def kernel_times(run, reps: int = 10, attempts: int = 3) -> dict:
    """Device ms per call of each kernel that `run` launches, from a
    profile_window that holds a kernel for every launch (retaken up to
    `attempts` times, then TraceIncomplete)."""
    import torch
    from torch.profiler import ProfilerActivity

    from stutter_tpu_torch.utils.profiling import (
        BURST_KERNEL, WINDOW_BURST, TraceIncomplete, check_complete, profile_window)

    run()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile_window([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        try:
            check_complete(prof.events(), "kernel_times' profile", WINDOW_BURST)
            break
        except TraceIncomplete:
            if attempt == attempts - 1:
                raise
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and BURST_KERNEL not in e.name:
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
    return lambda: _build.launch(fn, chunks, *ptrs, B, C, 1024, 256, f_taps.numel(),
                                 t_taps.numel(), *tiles, b, 1 - b,
                                 cfg.thresh_n_mult_nonstationary,
                                 cfg.sigmoid_slope_nonstationary, cfg.prop_decrease)


def spectromel_runner(lib, dev, B: int = 256, N: int = 49152, length: int = 48000,
                      plan=None):
    """The stats-mode launcher, by default at B=256 x 3 s: clips of `length`
    samples of tones in noise (the kind of input chip_smoke.py measures),
    the stats launch laid out by `plan` (the wrapper's stats_plan by
    default)."""
    import numpy as np
    import torch

    from stutter_tpu_torch import _build
    from stutter_tpu_torch.ops import consts
    from stutter_tpu_torch.ops import spectromel as sm

    n_fft, hop = 2048, 512
    T, K = N // hop + 1, n_fft // 2 + 1
    plan = plan or sm.stats_plan(B, T)
    rng = np.random.RandomState(0)
    t = np.arange(N) / 16000
    audio = (0.1 * rng.randn(B, N) + 0.4 * np.sin(2 * np.pi * rng.uniform(80, 3500, (B, 1)) * t))
    audio[:, length:] = 0
    audio = torch.from_numpy(audio.astype(np.float32)).to(dev)
    lengths = torch.full((B,), length, dtype=torch.int32, device=dev)
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
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
    ptrs = [x.data_ptr() for x in (audio, lengths, *tables, *outs)]
    return lambda: _build.launch(fn, audio, *ptrs, B, N, n_fft, hop,
                                 consts.frame_tile(n_fft, T, B), 128, 20, plan.cs, plan.rows, lo,
                                 hi, 12 / math.log(2.0))


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
    return lambda: _build.launch(fn, power, *ptrs, B, T, K, table.shape[1], table.shape[0] // 12,
                                 cs.cluster_size(B, T))


RUNNERS = {"spectral_gate.cu": gate_runner, "spectromel.cu": spectromel_runner,
           "chroma_stats.cu": chroma_runner}


# the stats launch's shapes: (B, N, clip length) -- a batch of 3 s clips, the
# MLP stream's windows, one 3 s request
STATS_SHAPES = ((256, 49152, 48000), (64, 48128, 48128), (1, 49152, 48000))


def stats_times(dev, card: str) -> None:
    """Each kernel's device time per call of the stats-mode wrapper
    (`ops.spectromel.spectromel`) at each of STATS_SHAPES, and a SHA-1 of
    the stats it returns: one JSON line a shape.  It calls only the wrapper,
    so it times any tree of the port whose package is first on the path,
    and two trees whose stats agree bit for bit print the same hash."""
    import numpy as np
    import torch

    from stutter_tpu_torch.ops.spectromel import spectromel

    for B, N, length in STATS_SHAPES:
        rng = np.random.RandomState(0)
        t = np.arange(N) / 16000
        audio = (0.1 * rng.randn(B, N)
                 + 0.4 * np.sin(2 * np.pi * rng.uniform(80, 3500, (B, 1)) * t))
        audio[:, length:] = 0
        audio = torch.from_numpy(audio.astype(np.float32)).to(dev)
        lengths = torch.full((B,), length, dtype=torch.int32, device=dev)
        stats = spectromel(audio, lengths)[1].cpu().numpy()
        print(json.dumps({"shape": [B, N], "length": length,
                          "ms": kernel_times(lambda: spectromel(audio, lengths)),
                          "stats_sha1": hashlib.sha1(stats.tobytes()).hexdigest(), "card": card}),
              flush=True)


def stats_plans(dev, card: str) -> None:
    """The stats launch's device time at each of STATS_SHAPES for every
    cluster size the bucket takes (1, 2, 4, 8 blocks a clip), beside the
    wrapper's choice: one JSON line a shape."""
    from stutter_tpu_torch import _build
    from stutter_tpu_torch.ops import spectromel as sm

    lib = _build.load_library("spectromel")
    for B, N, length in STATS_SHAPES:
        T = N // 512 + 1
        times = {}
        for cs in (1, 2, 4, 8):
            rows = -(-T // cs)
            plan = sm.StatsPlan(cs, rows, sm.stats_smem_bytes(rows))
            run = spectromel_runner(lib, dev, B, N, length, plan)
            times[cs] = kernel_times(lambda: _check(run()))["spectromel_stats"]
        print(json.dumps({"shape": [B, N], "length": length, "plan": sm.stats_plan(B, T)._asdict(),
                          "stats_ms_by_cs": times, "card": card}), flush=True)


# the stats launch's stages, each ending where its text ends in
# csrc/spectromel.cu: a clock64 stamp goes after each (--stats-timeline)
STATS_STAGES = (
    ("load", "  mbar_wait(bar_a, 0);\n"),
    ("max", "  cluster.sync();  // every warp's max is in every block\n"),
    ("floor", "  const float floor_db = warp_max(top) - 80.0f;\n"),
    ("dct", "  __syncthreads();  // the MFCC is in; the mel rows are free\n"),
    ("deltas", "    d2[i] = a2;\n  }\n  __syncthreads();\n"),
    ("gather", "  cluster.sync();  // every block's MFCC and deltas are in\n"),
    ("stats", "  cluster.sync();  // no block reads another's shared memory any more\n"),
)
STATS_START = "  const uint32_t bar_a = smem_addr(bar);\n"


def stats_timeline(dev, card: str) -> None:
    """SM cycles of each stage of the stats launch (STATS_STAGES) for the
    blocks of clip 0, at each of STATS_SHAPES with the wrapper's plan: a
    variant of csrc/spectromel.cu stamps clock64() from thread 0 of each
    block after each stage into a device array.  One JSON line a shape: the
    leader's cycles a stage and each rank's total."""
    import numpy as np
    import torch

    from stutter_tpu_torch import _build
    from stutter_tpu_torch.ops import spectromel as sm

    text = (_build.CSRC / "spectromel.cu").read_text()
    head = ("__device__ long long stats_stamps[8][16];\n#define STAMP(k) do { if (threadIdx.x == 0 "
            "&& blockIdx.y == 0) stats_stamps[blockIdx.x][k] = clock64(); } while (0)\n")
    text = text.replace("namespace cg = cooperative_groups;\n",
                        "namespace cg = cooperative_groups;\n" + head, 1)
    for k, (stage, anchor) in enumerate((("start", STATS_START), *STATS_STAGES)):
        if text.count(anchor) != 1:
            raise SystemExit(f"spectromel.cu: the text of stage {stage} is gone; update STATS_STAGES")
        text = text.replace(anchor, anchor + f"  STAMP({k});\n")
    text += ('\nextern "C" int stats_stamps_copy(void* dst) {\n'
             '  return (int)cudaMemcpyFromSymbol(dst, stats_stamps, sizeof(stats_stamps));\n}\n')
    with tempfile.TemporaryDirectory() as d:
        src, so = Path(d) / "spectromel.cu", Path(d) / "libspectromel-timeline.so"
        src.write_text(text)
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                              str(so), str(src)], capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"nvcc failed for the stats timeline:\n{res.stderr[-2000:]}")
        lib = ctypes.CDLL(str(so))
        lib.stats_stamps_copy.argtypes = [ctypes.c_void_p]
        for B, N, length in STATS_SHAPES:
            plan = sm.stats_plan(B, N // 512 + 1)
            run = spectromel_runner(lib, dev, B, N, length)
            for _ in range(3):  # warm, then the last launch's stamps
                _check(run())
            torch.cuda.synchronize()
            stamps = np.zeros((8, 16), np.int64)
            _check(lib.stats_stamps_copy(stamps.ctypes.data))
            cyc = np.diff(stamps[:plan.cs, :len(STATS_STAGES) + 1], axis=1)
            print(json.dumps({"shape": [B, N], "plan": plan._asdict(),
                              "leader_cycles": dict(zip((n for n, _ in STATS_STAGES),
                                                        cyc[0].tolist())),
                              "rank_total_cycles": cyc.sum(1).tolist(), "card": card}),
                  flush=True)


# (B, T_pad) of the encoder's attention: the corpus cell's fitted batches
# of 64, its last batch's 9 rows, one 10.24 s request
ATTENTION_SHAPES = ((64, 45), (64, 136), (64, 440), (9, 440), (1, 511))
FP32_RATE = 67e12  # one H100 SXM's FP32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12  # its device memory's bytes/s


# (B, T_pad) of Parakeet's attention: the long-form cell's four fitted
# batches of 8 recordings (57, 78, 105 and 148 s), one 148 s recording
XL_SHAPES = ((8, 719), (8, 978), (8, 1317), (8, 1856), (1, 1856))

# csrc/gated_attention.cu's modes -> (the model module, its attention core)
ATTENTION_MODES = {"gated": ("wavlm", "gated_attention"), "relkey": ("w2v_bert", "relkey_attention"),
                   "xl": ("parakeet", "xl_attention")}
# csrc/glu_depthwise.cu's instantiations -> (the model module, its conv core)
CONV_MODES = {"causal": ("w2v_bert", "glu_depthwise"), "centred": ("parakeet", "glu_conv_silu")}


def mode_shapes(mode: str):
    """The (B, T_pad) shapes a mode of either kernel is timed at."""
    return XL_SHAPES if mode in ("xl", "centred") else ATTENTION_SHAPES


def attention_model(mode: str):
    """`mode`'s model module and the name of its attention core there: the
    core is <name> (on a CUDA tensor the kernel, on a CPU tensor the plain
    version), its launch _<name>_cuda, its plain version <name>_plain, and
    the module's _LAUNCHES counts the launches."""
    import importlib

    module, name = ATTENTION_MODES[mode]
    return importlib.import_module(f"stutter_tpu_torch.models.{module}"), name


def clip_frames(B: int, T: int, seed: int):
    """B clips' frames for a batch padded to T: the first clip T, the last
    (B > 1) none, the rest drawn in [0.6 T, T] -> numpy int64 [B]."""
    import numpy as np

    rng = np.random.RandomState(seed)
    frames = rng.randint(max(1, int(0.6 * T)), T + 1, B)
    frames[0] = T
    if B > 1:
        frames[-1] = 0
    return frames


def frames_of(last):
    """Each clip's frames, int64 on the host, from an attention core's last
    argument: a frames tensor, or the packed rows' Clips."""
    return last.frames if hasattr(last, "offsets") else last.cpu().long()


def on_cpu(t):
    """A tensor, or the packed rows' Clips, on the CPU."""
    return t._replace(offsets=t.offsets.cpu()) if hasattr(t, "offsets") else t.cpu()


def attention_inputs(B: int, T: int, seed: int, device, cfg=None, mode: str = "gated"):
    """Layer 0's attention core of `mode` at `cfg`'s widths (WavLM-Large's
    for "gated", W2V-BERT 2.0's for "relkey", by default): its weights
    (the bucket embedding and the gate's; the distance_embedding), the
    activations the core takes (x, q, k, v; q, k, v), q, k, v as slices of
    one tensor, and where each clip's rows lie (clip_frames' clips).
    "gated": q, k, v [B, T, D] slices of one [B, T, 3 D] tensor, and the
    frames -> (p, cfg, x, q, k, v, frames int32).  "relkey": the same
    draws' rows of each clip's frames packed, q, k, v [R, D] slices of one
    [R, 3 D] tensor, and their Clips -> (p, cfg, q, k, v, clips).  "xl"
    (Parakeet's widths): bias_u and bias_v, the packed q, k, v, a drawn
    position table [2 T - 1, D] -> (p, cfg, q, k, v, table, clips)."""
    import torch

    from stutter_tpu_torch.config import ParakeetConfig, W2VBertConfig, WavLMConfig

    M, _ = attention_model(mode)
    cfg = cfg or {"gated": WavLMConfig, "relkey": W2VBertConfig, "xl": ParakeetConfig}[mode]()
    D, H = cfg.hidden_size, cfg.num_attention_heads
    g = torch.Generator().manual_seed(seed)
    if mode == "gated":
        pre = M.LAYER.format(0) + "attention."
        p = {pre + "rel_attn_embed.weight": torch.randn(cfg.num_buckets, H, generator=g),
             pre + "gru_rel_pos_linear.weight": 0.1 * torch.randn(M.GATE_DIM, D // H, generator=g),
             pre + "gru_rel_pos_linear.bias": 0.1 * torch.randn(M.GATE_DIM, generator=g),
             pre + "gru_rel_pos_const": 1 + 0.5 * torch.randn(1, H, 1, 1, generator=g)}
        acts = (torch.randn(B, T, D, generator=g).to(device),)
    elif mode == "relkey":
        nrel = cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1
        p = {M.LAYER.format(0) + "self_attn.distance_embedding.weight":
             torch.randn(nrel, D // H, generator=g)}
        acts = ()
    else:
        pre = M.LAYER.format(0) + "self_attn."
        p = {pre + "bias_u": 0.5 * torch.randn(H, D // H, generator=g),
             pre + "bias_v": 0.5 * torch.randn(H, D // H, generator=g)}
        acts = ()
    p = {k: t.to(device) for k, t in p.items()}
    qkv = torch.randn(B, T, 3 * D, generator=g)
    frames = clip_frames(B, T, seed)
    if mode != "gated":
        from stutter_tpu_torch.models.w2v_bert import pack_clips, pack_index

        f = torch.from_numpy(frames)
        qkv = qkv.reshape(B * T, 3 * D)[pack_index(f, T)]
        table = (torch.randn(2 * T - 1, D, generator=g).to(device),) if mode == "xl" else ()
        return (p, cfg, *qkv.to(device).split(D, dim=-1), *table, pack_clips(f, device))
    q, k, v = qkv.to(device).split(D, dim=-1)
    return (p, cfg, *acts, q, k, v, torch.tensor(frames, dtype=torch.int32, device=device))


def attention_ops(frames, cfg) -> float:
    """FP32 operations of the attention core of `cfg`'s model over clips of
    these frames, as the benchmark counts them (the attention of
    benchmark/counts/wavlm.py, counts/w2v_bert.py and counts/parakeet.py,
    which CPU tests hold this to): a row's term -- WavLM's gate, W2V-BERT's
    table of q . D over the left + right + 1 distances a head, Parakeet's
    q + u and q + v --, 8 a score for the bias, mask, scale and softmax, 2
    x 2 x d a pair (Parakeet: 3 x 2 x d, the positional product beside q
    k^T and P v)."""
    from stutter_tpu_torch.config import ParakeetConfig, W2VBertConfig

    d, h = cfg.hidden_size, cfg.num_attention_heads
    pair = 4 * d
    if isinstance(cfg, ParakeetConfig):
        row, pair = 2 * d, 6 * d
    elif isinstance(cfg, W2VBertConfig):
        row = 2 * d * (cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1)
    else:
        row = h * (2 * (d // h) * 8 + 18)
    return float(sum(int(t) * row + h * int(t) ** 2 * 8 + int(t) ** 2 * pair for t in frames))


def attention_check(B: int, T: int, dev, mode: str = "gated") -> dict:
    """`mode`'s kernel once at (B, T) on attention_inputs, against its plain
    version on the CPU: the worst gap |got - ref| / (1 + |ref|) over each
    clip's rows (padded: i < max(T_b, 1); packed: its T_b rows), whether
    every padded row past them is zero (packed rows have none), the
    launches the call counted and the device memory it allocated beyond
    its output (the plain version's [B, heads, T, T] float32 tensor beside
    it); then the pairs the kernel reports it multiplied on a second call,
    beside the model's attn_pairs_run x heads ("xl": also the positional
    products it reports beside pos_products_run x heads), and whether that
    call's output is the first's bit for bit -> a dict, with the inputs
    under "inputs"."""
    import torch

    M, name = attention_model(mode)
    core, cuda, plain = (getattr(M, name), getattr(M, f"_{name}_cuda"),
                         getattr(M, f"{name}_plain"))
    inputs = attention_inputs(B, T, B * 1000 + T + (7 if mode != "gated" else 0), dev, mode=mode)
    p, cfg, *acts = inputs
    frames = frames_of(acts[-1])
    core(p, 0, *acts, cfg)  # builds and caches what a first call builds
    torch.cuda.synchronize()
    before, base = M._LAUNCHES.launches, torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = core(p, 0, *acts, cfg)
    torch.cuda.synchronize()
    launches = M._LAUNCHES.launches - before
    extra = torch.cuda.max_memory_allocated(dev) - base - got.numel() * 4
    pairs = torch.zeros(2 if mode == "xl" else 1, dtype=torch.int64, device=dev)
    counted = cuda(p, 0, *acts, cfg, pairs=pairs)
    ref = plain({n: t.cpu() for n, t in p.items()}, 0, *(on_cpu(t) for t in acts), cfg)
    got, gap, zero, s = got.cpu(), 0.0, True, 0
    for b, n in enumerate(frames.tolist()):
        if got.dim() == 2:  # packed: the clip's own rows, none past them
            g, r, s = got[s : s + n], ref[s : s + n], s + n
        else:
            n = max(n, 1)
            g, r = got[b, :n], ref[b, :n]
            zero = zero and not bool(got[b, n:].any())
        if n:
            gap = max(gap, float(((g - r).abs() / (1 + r.abs())).max()))
    heads = cfg.num_attention_heads
    pos = ({"pos_products": int(pairs[1]), "pos_products_run": heads * M.pos_products_run(frames)}
           if mode == "xl" else {})
    return {"mode": mode, "shape": [B, T], "frames": [int(frames.min()), int(frames.max())],
            "gap": gap, "padded_rows_zero": zero, "launches": launches,
            "pairs": int(pairs[0]), **pos,
            "counted_call_equal": bool(torch.equal(counted.cpu(), got)),
            "pairs_run": heads * M.attn_pairs_run(frames),
            "pairs_valid": int((frames ** 2).sum()), "extra_bytes": int(extra),
            "btt_bytes": B * cfg.num_attention_heads * T * T * 4, "inputs": inputs}


def sdpa_call(p, cfg, *acts):
    """F.scaled_dot_product_attention on [B, heads, T, head_dim] views of q,
    k, v and the bias + key mask the plain version of cfg's model builds
    (WavLM's gated position bias, W2V-BERT's relative-key term), made once:
    the library's attention as a yardstick (the port never calls it on the
    card) -> a function of no argument."""
    import torch
    import torch.nn.functional as F

    from stutter_tpu_torch.config import ParakeetConfig, W2VBertConfig
    from stutter_tpu_torch.models import parakeet, w2v_bert, wavlm

    if isinstance(cfg, ParakeetConfig):
        q, k, v, pos, last = acts
    else:
        *_, q, k, v, last = acts
    frames = frames_of(last)
    if q.dim() == 2:  # packed rows, laid out [B, T] for the library
        B, T, D = len(frames), last.longest, q.shape[-1]
        idx = w2v_bert.pack_index(frames, T).to(q.device)
        q, k, v = (t.new_zeros(B * T, D).index_copy_(0, idx, t).view(B, T, D) for t in (q, k, v))
    B, T, _ = q.shape
    frames = frames.to(q.device)
    H = cfg.num_attention_heads
    q4, k4, v4 = (t.reshape(B, T, H, -1).transpose(1, 2) for t in (q, k, v))
    if isinstance(cfg, ParakeetConfig):
        qu, mask = parakeet.xl_terms(p, 0, q4, pos, frames)
        return lambda: F.scaled_dot_product_attention(qu, k4, v4, attn_mask=mask)
    if isinstance(cfg, W2VBertConfig):
        idx = w2v_bert.distance_index(T, cfg.left_max_position_embeddings,
                                      cfg.right_max_position_embeddings, q.device)
        dist = p[w2v_bert.LAYER.format(0) + "self_attn.distance_embedding.weight"]
        bias = w2v_bert.rel_key_scores(q4, dist, idx)
    else:
        bias = (wavlm.bias_gate(p, 0, acts[0], H)[..., None]
                * wavlm.position_bias(p, T, cfg, q.device))
    valid = wavlm._valid(frames, T) | (torch.arange(T, device=q.device) == 0)[None, :]
    mask = bias + wavlm.key_mask(valid)
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)


def attention_times(dev, card: str) -> None:
    """For each mode, at each of ATTENTION_SHAPES, attention_check and the
    device ms a call (torch.profiler) of the kernel, the plain version and
    SDPA (sdpa_call), beside the bound."""
    for mode in ATTENTION_MODES:
        M, name = attention_model(mode)
        core, plain = getattr(M, name), getattr(M, f"{name}_plain")
        for B, T in mode_shapes(mode):
            res = attention_check(B, T, dev, mode)
            p, cfg, *acts = inputs = res.pop("inputs")
            kernel = kernel_times(lambda: core(p, 0, *acts, cfg))
            plain_ms = kernel_times(lambda: plain(p, 0, *acts, cfg))
            sdpa = kernel_times(sdpa_call(*inputs))
            ops = attention_ops(frames_of(acts[-1]).tolist(), cfg)
            if mode == "xl":
                res["blocks_per_sm"] = M.xl_blocks_per_sm(dev)
            print(json.dumps({
                **res, "kernel_ms": sum(kernel.values()), "kernels": sorted(kernel),
                "plain_ms": sum(plain_ms.values()), "sdpa_ms": sum(sdpa.values()),
                "bound_ms": ops / FP32_RATE * 1e3, "flops": ops, "card": card}), flush=True)


def conv_model(mode: str):
    """`mode`'s model module and its conv core there: <name> (on a CUDA
    tensor the kernel, on a CPU tensor the plain version), its launch
    _<name>_cuda, its plain version <name>_plain, its launches
    <name>.launches."""
    import importlib

    module, name = CONV_MODES[mode]
    return importlib.import_module(f"stutter_tpu_torch.models.{module}"), name


def conv_inputs(frames, seed: int, device, mode: str = "causal"):
    """Layer 0's conv module core of `mode` at its model's published
    widths over clips of `frames` rows, packed: x [R, 2 C] (what the first
    pointwise conv gives), the depthwise conv's weights at their initial
    scale -- W2V-BERT's weight [C, 1, 31]; Parakeet's folded taps [C, 9]
    and bias [C] -- and the Clips -> (x, (weights...), clips)."""
    import torch

    from stutter_tpu_torch.config import ParakeetConfig, W2VBertConfig
    from stutter_tpu_torch.models import w2v_bert

    g = torch.Generator().manual_seed(seed)
    if mode == "causal":
        C, K = W2VBertConfig().hidden_size, W2VBertConfig().conv_depthwise_kernel_size
        w = (torch.randn(C, 1, K, generator=g) * math.sqrt(2.0 / K),)
    else:
        C, K = ParakeetConfig().hidden_size, ParakeetConfig().conv_kernel_size
        w = (torch.randn(C, K, generator=g) * math.sqrt(2.0 / K), 0.5 * torch.randn(C, generator=g))
    x = torch.randn(int(sum(frames)), 2 * C, generator=g)
    return x.to(device), tuple(t.to(device) for t in w), w2v_bert.pack_clips(frames, device)


def conv_bound(rows: int, channels: int, taps: int, mode: str = "causal") -> dict:
    """The least time of the GLU and the depthwise conv over `rows` x
    `channels` values: each value's two inputs read and its output written
    (12 bytes) over the HBM rate, or its operations (the GLU's 4, 2 a tap;
    "centred": and the bias's 1 and SiLU's 4) over the FP32 peak,
    whichever is larger."""
    per = 4 + 2 * taps + (5 if mode == "centred" else 0)
    n_bytes, ops = 12.0 * rows * channels, float(per * rows * channels)
    mem_ms, op_ms = n_bytes / HBM_RATE * 1e3, ops / FP32_RATE * 1e3
    return {"bound_ms": max(mem_ms, op_ms), "bound_by": "bytes" if mem_ms >= op_ms else "operations",
            "bytes": n_bytes, "flops": ops}


def conv_check(frames, dev, seed: int = 0, mode: str = "causal") -> dict:
    """`mode`'s conv kernel once on conv_inputs of clips of `frames` rows,
    against its plain version on the card: the worst gap |got - ref| / (1 +
    |ref|), the launches the call counted and the device memory it
    allocated beyond its output; then a second call into a NaN-filled
    buffer of 64 rows more than R: whether it wrote past row R, and whether
    its rows are the first call's bit for bit -> a dict, with the inputs
    under "inputs"."""
    import torch

    M, name = conv_model(mode)
    core, cuda, plain = (getattr(M, name), getattr(M, f"_{name}_cuda"),
                         getattr(M, f"{name}_plain"))
    x, w, clips = inputs = conv_inputs(frames, seed, dev, mode)
    core(x, *w, clips)  # builds the kernel
    torch.cuda.synchronize()
    before, base = core.launches, torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = core(x, *w, clips)
    torch.cuda.synchronize()
    launches = core.launches - before
    extra = torch.cuda.max_memory_allocated(dev) - base - got.numel() * 4
    R, C = got.shape
    buf = torch.full((R + 64, C), float("nan"), device=dev)
    again = cuda(x, *w, clips, out=buf)
    ref = plain(x, *w, clips)
    gap = float(((got - ref).abs() / (1 + ref.abs())).max()) if R else 0.0
    return {"mode": mode, "frames": [int(min(frames)), int(max(frames))], "clips": len(frames),
            "rows": R, "gap": gap, "launches": launches, "extra_bytes": int(extra),
            "written_past_rows": not bool(buf[R:].isnan().all()),
            "again_equal": bool(torch.equal(again, got)), "inputs": inputs}


def conv1d_call(x, w, clips):
    """The GLU and the depthwise conv as a padded layout runs them: each
    clip's rows laid out [B, T] (T its longest), the GLU, then F.conv1d
    channels first between two transposes -- W2V-BERT's weight [C, 1, K]
    with a left pad of K - 1; Parakeet's (taps [C, K], bias) centred, then
    SiLU -- (cuDNN's or ATen's depthwise conv, a yardstick the port does
    not call) -> a function of no argument."""
    import torch.nn.functional as F

    from stutter_tpu_torch.models import w2v_bert

    B, T = len(clips.frames), clips.longest
    idx = w2v_bert.pack_index(clips.frames, T).to(x.device)
    xp = x.new_zeros(B * T, x.shape[1]).index_copy_(0, idx, x).view(B, T, -1)
    if len(w) == 1:
        (wt,) = w
        K = wt.shape[-1]
        return lambda: F.conv1d(F.pad(F.glu(xp, dim=-1).transpose(1, 2), (K - 1, 0)), wt,
                                groups=wt.shape[0]).transpose(1, 2).contiguous()
    wt, b = w
    K = wt.shape[-1]
    return lambda: F.silu(F.conv1d(F.glu(xp, dim=-1).transpose(1, 2), wt[:, None], b,
                                   padding=(K - 1) // 2, groups=wt.shape[0])
                          ).transpose(1, 2).contiguous()


def conv_times(dev, card: str) -> None:
    """For each of CONV_MODES, at each of its shapes' clips (clip_frames),
    conv_check and the device ms a call (torch.profiler) of the kernel, the
    plain version and conv1d_call, beside conv_bound."""
    for mode in CONV_MODES:
        M, name = conv_model(mode)
        core, plain = getattr(M, name), getattr(M, f"{name}_plain")
        for B, T in mode_shapes(mode):
            frames = clip_frames(B, T, B * 1000 + T)
            res = conv_check(frames, dev, mode=mode)
            x, w, clips = res.pop("inputs")
            kernel = kernel_times(lambda: core(x, *w, clips))
            plain_ms = kernel_times(lambda: plain(x, *w, clips))
            lib = kernel_times(conv1d_call(x, w, clips))
            print(json.dumps({**res, "shape": [B, T], "kernel_ms": sum(kernel.values()),
                              "kernels": sorted(kernel), "plain_ms": sum(plain_ms.values()),
                              "conv1d_ms": sum(lib.values()), "conv1d_kernels": sorted(lib),
                              **conv_bound(res["rows"], w[0].shape[0], w[0].shape[-1], mode),
                              "card": card}), flush=True)


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA GPU available", file=sys.stderr)
        return 1
    from stutter_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if "--attention" in argv:
        attention_times(dev, card)
        return 0
    if "--conv" in argv:
        conv_times(dev, card)
        return 0
    if "--stats" in argv:
        stats_times(dev, card)
        return 0
    if "--stats-plans" in argv:
        stats_plans(dev, card)
        return 0
    if "--stats-timeline" in argv:
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip()
        stats_timeline(dev, f"{card}, max SM clock {clock}")
        return 0
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
