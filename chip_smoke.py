#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stutter_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the four
   CUDA sources from csrc/ with nvcc, all at once.
2. Holds each kernel (and the spectromel kernel's mel-output mode) against
   its plain PyTorch version on the card, at the paths' batch shapes, at
   the 10 s bucket and at the request shape (one 3 s clip), and times both
   (median of CUDA-event timings), beside the least time the card could
   take (`bound`) and, for the two FFT kernels, torch.fft.rfft over the
   same framed, windowed audio as a yardstick of the STFT stage.  Each
   kernel's device time per call comes from torch.profiler too; spectromel's
   tuning tail is timed on its own that way, beside its bound (the
   compacted candidates and frame counts read once, a bin written per
   clip), and so is its stats launch (launch 2: the valid dB mel rows read
   once and the stats written, against the DCT's FP32 operations), at
   B=256 x 3 s, the MLP stream's [64, 48128], one 3 s request and the 10 s
   bucket; two launches on the same input give bitwise-equal stats.  A 10 s clip whose candidates overflow the tail's shared memory
   (a comb of tones at every other FFT bin) checks the tail's
   over-capacity path.
3. Serving, 149-dim: writes full-width artifacts from a numpy seed
   (149-256-128-64-3 MLP with 8 seeds, a scaler, 3 classes), loads them with
   Predictor.load(device="cuda"), answers 8 predict_clip requests with
   denoise on and one predict_file on a 22.05 kHz WAV.
4. Corpus: writes a 905-clip WAV corpus (0.5-10 s, three classes, ~5 % at
   22.05 kHz) from a numpy seed, runs the port's preprocess, then
   extract_corpus for both variants and both suffixes on the card; checks
   every row, the dims, the JAX package's cache names, and 8 sampled rows
   against the CPU's plain path; prints clips/s per stage.
5. Serving, 286-dim (--variant 334, the main.py protocol with
   prop_decrease 0.8): 286-256-128-64-3 artifacts, the same 8 requests,
   CUDA against CPU.
6. Profiles one call each of the 149-dim batch front end, the batch gate,
   one 149-dim request and one request to the vote with torch.profiler:
   device time per kernel, launches, and the device's idle share of the
   wall time.
7. The headline model: writes the production quint (cnn, cnn_bilstm and
   the three transformer recipes, 3 classes, published widths) from a numpy
   seed through the port's persist_seq_head, its normalization stats from
   16 clips' frames, and ensemble.json; EnsemblePredictor.load(device=
   "cuda") and warmup(); 8 predict_clip requests (the mix of phase 3,
   denoise on), their p50; predict_batch of the 8 equal to predict_clip of
   each within 1e-5; 2 requests against the CPU's plain path (the same
   label, probabilities within 1e-3); predict_stream through the vote and
   through the MLP over a 70 s clip (windows/s over 7 passes: median, min,
   max), and over an 8 s clip against the CPU; then the port's HTTP
   service in-process (serve(..., ensemble=True, batch_window_ms=5)):
   /healthz, 8 concurrent /predict?model=ensemble beside one
   /stream?model=ensemble, each answer equal to the direct call, and
   requests/s over 12 more bursts of 8 (median, min, max a burst).  The
   HTTP path's launches are counted from its first request to its last,
   not over the server's warmup.
8. Training (its own numpy seed), after phase 7: writes a 905-clip corpus
   whose class sets the content (steady tones, gated tones, noise bursts;
   0.5-10 s, ~5 % at 22.05 kHz), runs preprocess, then run_cv
   (include_host=False) at the published MLPTrainConfig (256-128-64, 8
   seeds x 5 folds, 200 epochs, batch 128), run_before_after and run_cv at
   --variant 334, all on the card.  Checks MLP-TPU's CV accuracy >= 90 % at
   149 and 286 dims and engine A's "after" >= 90 %, every file the JAX
   package's run_cv and run_before_after write (with its CSV header), and
   Predictor.load(device="cuda") on the trained artifacts: the 8-request
   mix (denoise on), then the same clips without denoise against the CPU's
   plain path (the same labels, probabilities within 1e-3).  Ten
   GridTrainer steps at full width and G = 40 with fed batch rows and
   dropout masks, each held on its own to FP64 (`fed_step_phase`): from
   the state of an FP64 run of the same steps on the CPU, rounded to FP32,
   the card's step gives each entry's loss within 1e-5 relative and its
   gradients within 1e-4 (normwise, per entry and tensor; over a tenth of
   the terms' summed magnitude where a gradient cancels below that) of
   FP64's, with the card's own sign at the ReLU gates whose FP64
   pre-activation lies within FP32's error bound of zero (at most 1 % of
   an entry-step's gates), its update within 1e-4 of FP64 Adam's given its
   gradient, and every value it gives finite.
   The ten chained steps on the card and the CPU are gated on their step
   counts alone; their distances (card vs CPU, each vs FP64), the entry and
   the element that differ most are printed.  Prints run_cv's wall seconds,
   the CV grid's and the fit's steps/s (from the stage seconds run_cv
   returns), the card's idle share over a profiled window of CV steps,
   run_before_after's and the permutation importance's seconds.  Each
   entry point (preprocess, both run_cv, run_before_after) and the serving
   of the trained model count their launches apart.
9. Sequence training, on phase 8's corpus (its own numpy seed):
   run_cv(include_host=False, include_seq=True) trains the five members of
   the quint at their published widths and recipes, one seed x 5 folds
   (SEQ_EPOCHS epochs, 30 of the recipe's 80; the wall at 80 is projected
   from the measured stage times), their nested weighted vote and the
   refits; checks every <ARCH>-TPU row of FINAL_PERFORMANCE_TABLE.csv >= 80
   %, Weighted-Vote-TPU >= 90 %, and the JAX package's files and headers.  The trained vote behind
   EnsemblePredictor.load(device="cuda"): 8 requests (denoise on), each
   labelled with its corpus class, then the same clips without denoise
   against the CPU's plain path (labels equal, probabilities within 1e-3).
   Five fed steps of the CV grid's shape (G = 5, batch 64, t_max 316,
   published widths, the same draws; mixup on for the log-mel heads) for
   cnn, cnn_bilstm and transformer equal the CPU's normwise per tensor
   within 1e-4, or within twice the CPU's own FP32 distance from the same
   steps in FP64 where that is larger (a zero-initialized bias).
   train_sequence_model for the cnn checkpointed at half its steps,
   stopped there and resumed equals an uninterrupted run within 1e-5
   normwise.  Prints each architecture's CV-grid and refit steps/s
   (from stage_s), a profiled window of 20 grid steps per architecture
   (launches and device ms a step, idle share), the peak device memory of
   a chunk of G = 5 and of G = 25 (--seq-seeds 5), and run_cv's wall
   seconds and stages.
10. Data parallelism over a mesh of every visible GPU and, with one GPU,
   over make_mesh(devices=["cuda:0"] * 2), a split of the card into two
   shards (which checks the split and the gather, not two devices), each
   path against the same work unsharded: extract_features_sharded at
   B=256 x 3 s and denoise_sharded at B=64 x 3 s against the wrappers on
   one device, run_bucketed over the request mix, ensemble_sharded with
   the quint at its published widths (write_quint) on the request mix
   (B=8) against infer._ensemble_fused, cross_validate_mlp at G=40 (5
   folds x 8 seeds, published widths, 20 epochs), cross_validate_seq for
   the cnn (2 epochs, G = 5 x the mesh's size, 300 clips of 3 s), one
   data-parallel Adam step and train_mlp_dp for 3 epochs at 149-256-128-64-3,
   and dp_eval_accuracy, each against a mesh of one.  Every pair within
   PAR_TOL (max abs diff printed), labels and predictions equal, a mesh of
   one bitwise equal to the unsharded wrappers; each path's wall, sharded
   and unsharded, the median of PAR_REPS runs; one `parallel` JSON line.
11. The port's timing and trace primitives (utils.profiling) on the main
   path, after phase 6, in a process of its own (`profiling_main`: the
   card machine's profiler drops device events in a long process) and
   from their own numpy seed: prints mp3.available()
   and native_available() on this machine, then block_and_time (10
   dispatches) of a 3 s 149-dim predict_clip (denoise on), a 3 s
   predict_clip of the vote, extract_features_149_batch at B=256 x 3 s (a
   device tensor out) and the same batch over make_mesh(devices=["cuda:0"]
   * 2), both through extract_features_sharded and as the shards' device
   tensors (and over the last GPU when there are more), each held to at
   least 0.9 x the device time device_profile reads for the same call (a
   window with a device kernel for every launch) and printed beside that
   call's CUDA-event median; then trace() around one request of each model
   (traced anew, up to TRACE_ATTEMPTS times, where a trace raises
   TraceIncomplete): one trace file that parses as JSON, with a
   device event for each __global__ kernel of the path (the gate's three,
   spectromel's three and chroma_stats_kernel for the 149-dim request; the
   gate's three and spectromel_frames for the vote), one per launch of its
   wrapper as launch_counts reads them.
12. The attention kernel (csrc/gated_attention.cu) in each of its modes,
   WavLM's gated attention (padded rows) and W2V-BERT 2.0's relative-key
   attention (each clip's rows packed, read from its offset), after phase
   2, from its own numpy seed: at the corpus cells' shapes (fitted batches
   of 64 at T 45, 136 and 440, 9 rows at 440, one request at 511; ragged
   clips, one of no frames), q, k and v read by strides, each clip's rows
   within ATTN_TOL (1e-5, |got - ref| / (1 + |ref|)) of the plain version
   on the CPU, the padded rows past its frames zero, one launch a call,
   no device memory beyond the output, and the pairs the kernel reports it
   multiplied equal to attn_pairs_run x heads; the kernel, the plain
   version and SDPA on the plain version's mask timed beside the bound
   (the benchmark's FP32 operations over 67 TFLOP/s).  The conv module's
   kernel (csrc/glu_depthwise.cu) at the same shapes' clips packed: within
   ATTN_TOL of its plain version on the card, one launch a call, nothing
   written past row R, timed (CUDA events and profiler device ms) beside
   its plain version, the padded path's GLU and F.conv1d between two
   transposes, and its bound (12 bytes a value over 3.35 TB/s).  Then one
   encode call of WavLM-Large and one of W2V-BERT 2.0 (weights drawn on
   the card) on the same 9 clips of 0.01-10.24 s: 24 launches of each of
   the model's kernels (W2V-BERT: the relative-key mode and the conv
   kernel) and none of another, the kernels' device time in it beside the
   bound of that call's frames, and the embeddings finite (the clip of no
   frame's zero); in W2V-BERT's call no depthwise conv of ATen's or
   cuDNN's, and one conv module call's kernels hold the conv kernel and no
   copy.
13. Prints the kernels' JSON line, then {"ok": true, "device": {...}} last.

Phase 2 also holds the kernels at the stream paths' shapes: the vote's
segment, one [1, 2**20] buffer, through the gate and the mel mode without
the tuning tail (as the sequence featurizer runs it), and the MLP stream's
windows, [64, 48128], through the stats mode and chroma_stats.

Every profile window (device_ms, device_profile, trace) is
utils.profiling.profile_window's: on the card machine the profiler loses
the first kernels of a window, more as a process runs, so the window
opens on idle host time and a burst of tiny kernels (left out of every
count and time here).  A window that still holds fewer kernels than
launches is retaken (kernel_times up to 3 times,
then it raises; phase 11's device_profile up to 3 times, then the phase
fails); the other profiles print whether their window was complete.

Each of the paths 3-5 and 7-11, and phase 12's encode calls, runs with
every launch count set to 0 just before it and read just after, and fails
if a kernel it uses never launched.

Any failed check raises, so the exit code is non-zero and no result line is
printed.  Without a CUDA GPU it exits with code 1 at once.
"""

from __future__ import annotations

import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SR = 16000
LIBRARIES = ("spectromel", "chroma_stats", "spectral_gate", "gated_attention",
             "glu_depthwise")  # csrc/<name>.cu
KERNELS = {  # kernel (mode) -> (source, the TPU kernel it replaces, or None)
    "spectromel": ("stutter_tpu_torch/csrc/spectromel.cu",
                   "stutter_tpu/ops/pallas_spectromel.py:409"),
    "spectromel_mel": ("stutter_tpu_torch/csrc/spectromel.cu",
                       "stutter_tpu/ops/pallas_spectromel.py:409"),
    "chroma_stats": ("stutter_tpu_torch/csrc/chroma_stats.cu",
                     "stutter_tpu/ops/pallas_chroma.py:95"),
    "spectral_gate": ("stutter_tpu_torch/csrc/spectral_gate.cu",
                      "stutter_tpu/ops/pallas_denoise.py:265"),
    # the attention cores of WavLM and W2V-BERT, the two modes of one
    # kernel: the JAX package has neither model
    "gated_attention": ("stutter_tpu_torch/csrc/gated_attention.cu", None),
    "relkey_attention": ("stutter_tpu_torch/csrc/gated_attention.cu", None),
    # W2V-BERT's conv module core (GLU and causal depthwise conv, packed rows)
    "glu_depthwise": ("stutter_tpu_torch/csrc/glu_depthwise.cu", None),
    # Parakeet's attention core (the kernel's third mode, head width 128) and
    # conv module core (GLU, centred depthwise conv, SiLU): no JAX counterpart
    "xl_attention": ("stutter_tpu_torch/csrc/gated_attention.cu", None),
    "glu_conv_silu": ("stutter_tpu_torch/csrc/glu_depthwise.cu", None),
}
# the front end's kernels, which every featurizing path launches
FRONT_END_KERNELS = ("spectromel", "spectromel_mel", "chroma_stats", "spectral_gate")
N_CORPUS, CLASSES = 905, ("block", "fluent", "repetition")
N_TRAIN = 905  # the training phase's corpus
# phase 9's epochs: the published recipe's 80 would take the BiLSTM's grid
# alone ~4 minutes on the card (its loop of packed LSTMs is launch-bound),
# so the phase runs 30 and prints run_cv's wall projected to 80
SEQ_EPOCHS = 30
SEQ_WINDOW = 20  # phase 9's profiled grid steps
PAR_REPS, PAR_TOL = 5, 1e-5  # phase 10: timed runs of each path; sharded vs unsharded bound
ATTN_TOL = 1e-5  # phase 12: the attention kernel's worst |got - ref| / (1 + |ref|)
# phase 12's encode run: seconds of its 9 clips, the first too short for a frame
ENCODE_S = (0.01, 0.5, 1.2, 2.5, 3.0, 4.4, 6.0, 8.1, 10.24)
QUINT = {"cnn": 0.2, "cnn_bilstm": 0.15, "transformer": 0.2, "transformer_lr1e3": 0.2,
         "transformer_mix4_lr1e3": 0.25}  # member -> vote weight
REQUEST_S = (1.5, 3, 3, 3, 3, 5, 6, 10)  # the request mix (s)
STREAM_PASSES, HTTP_BURSTS = 7, 12  # timed passes over the 70 s stream; bursts of 8 requests
# one H100 SXM at 700 W (its datasheet peak rates): HBM bytes/s,
# FP32 FLOP/s outside the tensor cores
HBM_RATE, FP32_RATE = 3.35e12, 67e12


def bound(n_bytes: float, flops: float) -> dict:
    """The least time for the work: each input read once and each output
    written once at the memory rate, or the FP32 operations at the peak
    rate, whichever is larger."""
    mem_ms, op_ms = n_bytes / HBM_RATE * 1e3, flops / FP32_RATE * 1e3
    return {"bound_ms": max(mem_ms, op_ms), "bound_by": "bytes" if mem_ms >= op_ms else "operations",
            "bytes": n_bytes, "flops": flops}


def fft_flops(n_frames: int, n_fft: int) -> float:
    """Real FFTs of n_fft points: 2.5 n log2 n operations each."""
    return n_frames * 2.5 * n_fft * np.log2(n_fft)


def mel_nonzeros(n_fft: int, n_mels: int = 128) -> int:
    from stutter_tpu_torch.ops.consts import mel_sparse

    return int(mel_sparse(SR, n_fft, n_mels)[1].size)


def stft_library_ms(framed) -> float:
    """torch.fft.rfft over framed, windowed audio: the STFT stage as one
    library call, timed as a yardstick only (the port never calls it on the
    card's path)."""
    import torch

    return time_ms(lambda: torch.fft.rfft(framed, dim=-1))


def structured_clips(rng, n_clips: int, n: int) -> np.ndarray:
    """Tones at random frequencies plus noise, some gated on and off."""
    t = np.arange(n) / SR
    out = np.zeros((n_clips, n), np.float32)
    for i in range(n_clips):
        y = rng.randn(n) * rng.uniform(0.01, 0.2)
        for _ in range(rng.randint(1, 4)):
            y += rng.uniform(0.1, 0.5) * np.sin(2 * np.pi * rng.uniform(80, 3500) * t
                                                + rng.uniform(0, 2 * np.pi))
        if i % 3 == 1:
            y *= (t % rng.uniform(0.2, 0.6)) < 0.15
        out[i] = y
    return out


def time_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn) -> dict:
    """Device ms per call of each kernel `fn` launches (torch.profiler)."""
    from stutter_tpu_torch.tools.kernel_phases import kernel_times

    return kernel_times(fn)


def tail_numbers(p, n_fft: int) -> dict:
    """The tuning tail's least time -- the frame counts and the compacted
    candidates (a u32 key and a u8 bin each) read once, one int32 written
    per clip -- and its plain version's time on the same compacted
    candidates.  The candidates are this run's, from the plain piptrack on
    the kernel's power (the same arithmetic as the kernel's)."""
    from stutter_tpu_torch.ops.chroma import (
        compact_candidates, piptrack_candidates, tuning_bin_from_compacted)

    keys, bins, counts = compact_candidates(*piptrack_candidates(p, SR, n_fft))
    n = int(counts.sum())
    B, T = counts.shape
    return {"candidates": n, "max_clip_candidates": int(counts.sum(1).max()),
            **bound(4 * B * T + 5 * n + 4 * B, 0.0),
            "plain_ms": time_ms(lambda: tuning_bin_from_compacted(keys, bins, counts))}


def stats_launch_numbers(dev_ms: dict, B: int, T: int, length: int) -> dict:
    """Spectromel's stats launch (launch 2) on its own: its device time from
    the wrapper's profile, its plan, and its least time -- the valid dB mel
    rows read once and the stats written once, against the DCT's FP32
    operations (2 x 128 x 20 a valid frame)."""
    from stutter_tpu_torch.ops.spectromel import stats_plan

    nv = min(1 + length // 512, T)
    return {"ms": dev_ms["spectromel_stats"], "plan": stats_plan(B, T)._asdict(),
            **bound(4 * (B * nv * 128 + B * 6 * 20), B * nv * 2 * 128 * 20)}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def launch_counts(reset: bool = False) -> dict:
    """Every wrapper's kernel launches so far, by kernel (mode); reset=True
    then sets them to 0."""
    from stutter_tpu_torch.models import w2v_bert, wavlm
    from stutter_tpu_torch.ops.chroma_stats import chroma_stats
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate
    from stutter_tpu_torch.ops.spectromel import spectromel

    from stutter_tpu_torch.models import parakeet

    counters = {"spectromel": (spectromel, "launches"),
                "spectromel_mel": (spectromel, "mel_launches"),
                "chroma_stats": (chroma_stats, "launches"),
                "spectral_gate": (spectral_gate, "launches"),
                "gated_attention": (wavlm.gated_attention, "launches"),
                "relkey_attention": (w2v_bert.relkey_attention, "launches"),
                "glu_depthwise": (w2v_bert.glu_depthwise, "launches"),
                "xl_attention": (parakeet.xl_attention, "launches"),
                "glu_conv_silu": (parakeet.glu_conv_silu, "launches")}
    counts = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    if reset:
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
    return counts


def check_launched(counts: dict, kernels, path: str) -> None:
    check(all(counts[k] > 0 for k in kernels), f"{path}: a kernel never launched: {counts}")


def counted_entry(launches: dict, name: str, kernels, fn):
    """fn() with the launch counts set to 0 just before and read just after
    into launches[name], each of `kernels` launched -> (its result, its wall
    seconds)."""
    import torch

    launch_counts(reset=True)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    launches[name] = launch_counts(reset=True)
    check_launched(launches[name], kernels, name)
    return out, s


def compare_spectromel(rng, dev, B: int, N: int, length: int, timed: bool):
    """-> (results, (power, tuning bin, lengths) of the kernel for chroma_stats)."""
    import torch

    from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
    from stutter_tpu_torch.ops.spectral import frame, hann
    from stutter_tpu_torch.ops.spectromel import spectromel, spectromel_plain

    audio = torch.from_numpy(structured_clips(rng, B, N)).to(dev)
    audio[:, length:] = 0
    lengths = torch.full((B,), length, dtype=torch.int32, device=dev)
    p, st, tb = spectromel(audio, lengths)
    pp, stp, tbp = spectromel_plain(audio, lengths)
    torch.cuda.synchronize()
    rel = float((p - pp).abs().max() / pp.abs().max())
    err = (st - stp).abs()
    tb_own = estimate_tuning_bin(p, SR, 2048)
    res = {"B": B, "N": N, "power_rel_err": rel, "stats_max_err": float(err.max()),
           "stats_mean_err": float(err.mean()),
           "tb_equal_to_own_power": bool(torch.equal(tb, tb_own)),
           "tb_agree_with_plain": int((tb == tbp).sum())}
    check(torch.isfinite(st).all().item(), "spectromel stats not finite")
    check(rel < 1e-5, f"spectromel power rel err {rel}")
    check(res["stats_max_err"] < 2e-3 and res["stats_mean_err"] < 2e-4,
          f"spectromel stats err {res['stats_max_err']} / {res['stats_mean_err']}")
    check(res["tb_equal_to_own_power"], "spectromel tuning bin != plain estimate on its power")
    T, K = p.shape[1:]
    # power, stats and tuning bin out; FFT, |.|^2, the sparse mel and the DCT
    res.update(bound(4 * (B * N + B + B * T * K + B * 6 * 20 + B),
                     fft_flops(B * T, 2048) + B * T * (3 * K + 2 * mel_nonzeros(2048) + 2 * 128 * 20)))
    # two launches on the same input give the same stats, bit for bit
    res["stats_bitwise_repeatable"] = bool(torch.equal(spectromel(audio, lengths)[1], st))
    check(res["stats_bitwise_repeatable"], "spectromel stats differ between two launches")
    if timed:
        res["ms"] = time_ms(lambda: spectromel(audio, lengths))
        res["plain_ms"] = time_ms(lambda: spectromel_plain(audio, lengths))
        res["device_ms"] = device_ms(lambda: spectromel(audio, lengths))
        res["tail"] = {"ms": res["device_ms"]["tuning_tail"], **tail_numbers(p, 2048)}
        res["stats_launch"] = stats_launch_numbers(res["device_ms"], B, T, length)
        framed = frame(audio, 2048, 512) * hann(2048, dev)
        res["stft_library_ms"] = stft_library_ms(framed)
        del framed
    return res, (p, tb, lengths)


def compare_spectromel_mel(rng, dev, B: int, N: int, n_fft: int = 512, hop: int = 256,
                           with_tuning: bool = True) -> dict:
    """The mel-output mode, by default at the 286-dim variant's geometry
    (n_fft 512, hop 256): clip lengths from N / 4 to N, the last clip
    silent (one clip of N - 1000 samples at B=1).  with_tuning=False skips
    the tail, as the sequence featurizer does (n_fft 2048, hop 512)."""
    import torch

    from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
    from stutter_tpu_torch.ops.spectral import frame, hann
    from stutter_tpu_torch.ops.spectromel import spectromel, spectromel_plain

    audio = torch.from_numpy(structured_clips(rng, B, N)).to(dev)
    lens = rng.randint(N // 4, N + 1, size=B).astype(np.int32)
    lens[0] = N if B > 1 else N - 1000
    if B > 1:
        audio[-1] = 0
    for b, n in enumerate(lens):
        audio[b, n:] = 0
    lengths = torch.from_numpy(lens).to(dev)
    kw = dict(n_fft=n_fft, hop_length=hop, with_stats=False, with_tuning=with_tuning)
    p, m, tb = spectromel(audio, lengths, **kw)
    pp, mp, tbp = spectromel_plain(audio, lengths, **kw)
    torch.cuda.synchronize()
    res = {"B": B, "N": N, "n_fft": n_fft, "hop": hop, "with_tuning": with_tuning,
           "power_rel_err": float((p - pp).abs().max() / pp.abs().max()),
           "mel_rel_err": float((m - mp).abs().max() / mp.abs().max()),
           "mel_max_abs_err": float((m - mp).abs().max())}
    check(torch.isfinite(m).all().item(), "spectromel mel not finite")
    check(res["power_rel_err"] < 1e-5, f"spectromel mel mode power rel err {res}")
    check(res["mel_rel_err"] < 1e-4, f"spectromel mel mode mel rel err {res}")
    if with_tuning:
        res.update(tb_equal_to_own_power=bool(torch.equal(tb, estimate_tuning_bin(p, SR, n_fft))),
                   tb_agree_with_plain=int((tb == tbp).sum()), tb_last=int(tb[-1]))
        check(res["tb_equal_to_own_power"] and (B == 1 or res["tb_last"] == 50),
              f"spectromel mel mode tuning bin != plain estimate on its power: {res}")
    else:
        check(tb is None and tbp is None, "spectromel without tuning returned a tuning bin")
    T, K = p.shape[1:]
    # power, mel (and the tuning bin) out; FFT, |.|^2 and the sparse mel
    res.update(bound(4 * (B * N + B + B * T * K + B * T * 128 + B * with_tuning),
                     fft_flops(B * T, n_fft) + B * T * (3 * K + 2 * mel_nonzeros(n_fft))))
    res["ms"] = time_ms(lambda: spectromel(audio, lengths, **kw))
    res["plain_ms"] = time_ms(lambda: spectromel_plain(audio, lengths, **kw))
    res["device_ms"] = device_ms(lambda: spectromel(audio, lengths, **kw))
    if with_tuning:
        res["tail"] = {"ms": res["device_ms"]["tuning_tail"], **tail_numbers(p, n_fft)}
    else:
        check("tuning_tail" not in res["device_ms"], f"the tail ran: {res['device_ms']}")
    framed = frame(audio, n_fft, hop) * hann(n_fft, dev)
    res["stft_library_ms"] = stft_library_ms(framed)
    return res


def comb_clip(n: int, N: int) -> np.ndarray:
    """Tones at every other FFT bin (n_fft 2048) of piptrack's band, random
    phases: nearly every other bin of every frame is a candidate, ~77k in
    10 s, more than a block's shared memory holds."""
    t = np.arange(N) / SR
    phases = np.random.RandomState(7).uniform(0, 2 * np.pi, 256)
    y = sum(np.sin(2 * np.pi * k * SR / 2048 * t + phases[k // 2]) for k in range(20, 512, 2))
    y[n:] = 0
    return (0.05 * y).astype(np.float32)


def compare_tail_over_capacity(rng, dev) -> dict:
    """The 10 s bucket at B=2: the comb clip, whose candidates overflow the
    tail's shared memory (its over-capacity path), and a clip of tones in
    noise; each tuning bin equal to the plain estimate on the kernel's
    power."""
    import torch

    from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
    from stutter_tpu_torch.ops.spectromel import spectromel

    N, n = 163840, 160000
    audio = np.stack([comb_clip(n, N), structured_clips(rng, 1, N)[0]])
    audio[1, n:] = 0
    audio = torch.from_numpy(audio).to(dev)
    lengths = torch.full((2,), n, dtype=torch.int32, device=dev)
    p, _, tb = spectromel(audio, lengths)
    res = {"tb": tb.tolist(), "tb_equal_to_own_power": bool(torch.equal(
        tb, estimate_tuning_bin(p, SR, 2048))), **tail_numbers(p, 2048)}
    check(res["max_clip_candidates"] * 5 > 232448,
          f"the comb clip does not overflow the tail's shared memory: {res}")
    check(res["tb_equal_to_own_power"], f"tail over capacity != plain estimate: {res}")
    return res


def compare_chroma_stats(p, tb, lengths) -> dict:
    import torch

    from stutter_tpu_torch.ops.chroma_stats import chroma_stats, chroma_stats_plain, cluster_size

    n_valid = 1 + torch.div(lengths, 512, rounding_mode="floor")
    got = chroma_stats(p, tb, n_valid)
    ref = chroma_stats_plain(p, tb, n_valid)
    err = float((got - ref).abs().max())
    check(err < 1e-5, f"chroma_stats err {err}")
    B, T, K = p.shape
    # power, tuning bin and n_valid in, [B, 24] out; the 12-row projection
    return {"B": B, "shape": [B, T, K], "max_err": err, "cluster": cluster_size(B, T),
            **bound(4 * (B * T * K + 2 * B + 24 * B), B * T * 2 * K * 12),
            "ms": time_ms(lambda: chroma_stats(p, tb, n_valid)),
            "plain_ms": time_ms(lambda: chroma_stats_plain(p, tb, n_valid)),
            "device_ms": device_ms(lambda: chroma_stats(p, tb, n_valid))}


def compare_gate(rng, dev, B: int, N: int, timed: bool) -> dict:
    import torch

    from stutter_tpu_torch.config import DenoiseConfig
    from stutter_tpu_torch.denoise import PAD, denoise_batch
    from stutter_tpu_torch.ops.consts import mask_smoothing_profiles
    from stutter_tpu_torch.ops.spectral import hann
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate_plain

    cfg = DenoiseConfig()
    if N == 4096:  # the shapes and inputs of tests/test_denoise.py:188
        t = np.arange(N) / SR
        clean = 0.5 * np.sin(2 * np.pi * 440 * t) * (t % 0.25 < 0.125)
        audio = np.stack([clean + rng.randn(N) * 0.05, rng.randn(N) * 0.2]).astype(np.float32)
        lens = np.asarray([N, 3000], np.int32)
    else:
        audio = structured_clips(rng, B, N)
        lens = np.full(B, N - 1000, np.int32)
        audio[:, N - 1000:] = 0
    audio, lengths = torch.from_numpy(audio).to(dev), torch.from_numpy(lens).to(dev)
    got = denoise_batch(audio, lengths, cfg)
    ref = denoise_batch(audio, lengths, cfg, gate=spectral_gate_plain)
    err = float((got - ref).abs().max())
    g, r = got - got.mean(1, keepdim=True), ref - ref.mean(1, keepdim=True)
    corr = float(((g * r).sum(1) / (g.norm(dim=1) * r.norm(dim=1) + 1e-12)).min())
    res = {"B": B, "N": N, "max_err": err, "min_corr": corr}
    check(torch.isfinite(got).all().item(), "spectral_gate output not finite")
    if N == 4096:
        check(err < 5e-5, f"spectral_gate err {err} at the test shapes")
        check(float(got[1, 3000:].abs().max()) == 0.0, "spectral_gate padding not exactly 0")
    else:
        check(err < 0.03 and corr > 0.9999, f"spectral_gate err {err}, corr {corr}")
    # denoise_batch's geometry: PAD zeros each side, centred frames at hop 256
    C = -(-(N + 2 * PAD) // 256) + 4
    T, K = C - 3, 513
    kf, kt = (len(t) for t in mask_smoothing_profiles(cfg))
    # audio and lengths in, [B, N] out; per frame two FFTs and |.|, per bin
    # the two IIR passes and the mask (16), the smoothing taps, the blend
    res.update(bound(4 * (2 * B * N + B),
                     2 * fft_flops(B * T, 1024) + B * T * K * (16 + 2 * (kf + kt))))
    if timed:
        res["ms"] = time_ms(lambda: denoise_batch(audio, lengths, cfg))
        res["plain_ms"] = time_ms(lambda: denoise_batch(audio, lengths, cfg,
                                                        gate=spectral_gate_plain))
        x = torch.nn.functional.pad(audio, (PAD + 512, C * 256 - N - PAD - 512))
        res["stft_library_ms"] = stft_library_ms(x.unfold(-1, 1024, 256) * hann(1024, dev))
        del x
    return res


def device_profile(fn, reps: int = 3, attempts: int = 1) -> dict:
    """torch.profiler over `reps` calls of `fn` after a warm one, in a
    window of utils.profiling.profile_window, retaken up to
    `attempts` times until it holds a device kernel for every launch (a
    window over many training steps takes tens of seconds, so only phase
    11, which checks completeness, retakes):
    wall ms per call (under the profiler), device ms per call (the
    kernels' and copies' durations), the device's idle share of the wall
    time, launches per call, the eight kernels with the most device time,
    whether the window was complete and the windows it took."""
    import re

    import torch
    from torch.profiler import ProfilerActivity

    from stutter_tpu_torch.utils.profiling import (
        BURST_KERNEL, WINDOW_BURST, TraceIncomplete, check_complete, profile_window)

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile_window([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        try:
            check_complete(prof.events(), "device_profile's window", WINDOW_BURST)
            complete = True
            break
        except TraceIncomplete:
            complete = False
    by_name: dict[str, list] = {}
    for e in prof.events():
        # kernels and copies only: a user annotation (the optimizer's
        # `Optimizer.step#Adam.step` range) lies on the device's timeline
        # too, over the kernels it encloses
        if (e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation
                or BURST_KERNEL in e.name):
            continue
        name = re.sub(r"\(anonymous namespace\)::", "", e.name).split("(")[0][:60]
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3 / reps
        acc[1] += 1
    device = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall, "device_ms": device,
            "idle_share": 1.0 - device / wall if wall > 0 else None,
            "launches": sum(v[1] for v in by_name.values()) / reps,
            "top": [[k, v[0], v[1] / reps] for k, v in top],
            "complete": complete, "windows": attempt}


def profile_batches(rng, dev) -> dict:
    """Device profiles of the 149-dim front end at B=256 x 3 s and the gate
    (denoise_batch) at B=64 x 3 s."""
    import torch

    from stutter_tpu_torch.config import DenoiseConfig
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.ops.frontend import extract_features_149_batch

    out = {}
    for name, B, fn in (("features_149_B256", 256, extract_features_149_batch),
                        ("denoise_B64", 64, lambda a, n: denoise_batch(a, n, DenoiseConfig()))):
        audio = torch.from_numpy(structured_clips(rng, B, 49152)).to(dev)
        lengths = torch.full((B,), 48000, dtype=torch.int32, device=dev)
        out[name] = device_profile(lambda: fn(audio, lengths))
    return out


def profile_request(rng, dev, out_dir: str, cfg) -> dict:
    """The device profile of one 3 s predict_clip request, denoise on."""
    from stutter_tpu_torch.infer import Predictor

    pred = Predictor.load(out_dir, cfg, device=dev)
    y = structured_clips(rng, 1, 3 * SR)[0]
    return device_profile(lambda: pred.predict_clip(y))


def write_artifacts(rng, out_dir: str, dev, cfg) -> None:
    """Full-width artifacts in the JAX package's files, via the port: a
    D-256-128-64-3 MLP with 8 seeds for the variant's D, a scaler fitted on
    16 clips' features."""
    from stutter_tpu_torch import persist
    from stutter_tpu_torch.models.mlp import SeedMLP
    from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler
    from stutter_tpu_torch.ops.frontend import extract_features_numpy

    dims, n_seeds = (cfg.features.total_feature_len, 256, 128, 64, 3), 8
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = (rng.randn(n_seeds, a, b) * np.sqrt(2.0 / a)).astype(np.float32)
        params[f"b{i}"] = (rng.randn(n_seeds, b) * 0.05).astype(np.float32)
    clips = list(structured_clips(rng, 16, 3 * SR))
    feats = extract_features_numpy(clips, cfg.features, device=dev)
    persist.save_mlp(os.path.join(out_dir, "model_mlp_tpu"), SeedMLP.from_jax_params(params, device=dev))
    persist.save_scaler(os.path.join(out_dir, "scaler_after.npz"), StandardScaler.fit(feats))
    persist.save_label_encoder(os.path.join(out_dir, "label_encoder.json"),
                               LabelEncoder(classes_=list(CLASSES)))


def serve_requests(rng, dev, out_dir: str, cfg, kernels, cpu_denoise: bool) -> dict:
    """8 predict_clip requests (denoise on) + 1 predict_file of a 22.05 kHz
    WAV on the card, counted; then two requests on the CPU's plain path,
    denoised as `cpu_denoise` says, must give the same label and
    probabilities within 1e-3."""
    import torch

    from stutter_tpu_torch.io.wav import write_wav
    from stutter_tpu_torch.infer import Predictor

    pred = Predictor.load(out_dir, cfg, device=dev)
    pred.warmup()
    durations = (1.5, 3, 3, 3, 3, 5, 6, 10)
    clips = [structured_clips(rng, 1, int(d * SR))[0] for d in durations]
    wav = os.path.join(out_dir, "request_22k.wav")
    write_wav(wav, structured_clips(rng, 1, int(2.5 * 22050))[0] * 0.5, 22050)

    launch_counts(reset=True)
    latencies, results = [], []
    for y in clips:
        t0 = time.perf_counter()
        results.append(pred.predict_clip(y))
        latencies.append((time.perf_counter() - t0) * 1e3)
    results.append(pred.predict_file(wav))
    launches = launch_counts()

    for r in results:
        p = np.array(list(r["proba"].values()))
        check(len(p) == 3 and np.isfinite(p).all() and abs(p.sum() - 1) < 1e-5,
              f"bad probabilities {r}")
    check_launched(launches, kernels, "serving")

    # the same clips through the plain versions on the CPU give the same answer
    cpu = Predictor.load(out_dir, cfg, device="cpu")
    diff = 0.0
    for y in clips[1:3]:
        a = pred.predict_clip(y, denoise=cpu_denoise)
        b = cpu.predict_clip(y, denoise=cpu_denoise)
        diff = max(diff, max(abs(a["proba"][c] - b["proba"][c]) for c in a["proba"]))
        check(a["label"] == b["label"] and diff < 1e-3, f"cuda vs cpu predict: {a} {b}")
    torch.cuda.synchronize()
    return {"launches": launches, "p50_ms": statistics.median(latencies),
            "latencies_ms": latencies, "labels": [r["label"] for r in results],
            "cuda_vs_cpu_max_proba_diff": diff}


def write_quint(rng, out_dir: str, dev) -> None:
    """The production quint at its published widths in the JAX package's
    files, via the port: random weights at each head's init scales from
    `rng`, each kind's normalization stats from 16 clips' frames, and
    ensemble.json."""
    from stutter_tpu_torch.train.seq_pipeline import ARCHS, persist_seq_head
    from stutter_tpu_torch.train.seq_trainer import prepare_sequence_dataset, standardize_sequences

    clips = list(structured_clips(rng, 16, 3 * SR))
    norms = {kind: standardize_sequences(*prepare_sequence_dataset(clips, kind, device=dev))[1:]
             for kind in ("logmel", "mfcc_deltas")}
    for arch in QUINT:
        spec = ARCHS[arch]
        persist_seq_head(out_dir, arch, spec["init_fn"](rng, **spec["init_kwargs"](len(CLASSES))),
                         *norms[spec["kind"]], list(CLASSES))
    with open(os.path.join(out_dir, "ensemble.json"), "w") as f:
        json.dump({"weights": QUINT, "classes": list(CLASSES)}, f)


def proba_diff(a: dict, b: dict) -> float:
    return max(abs(a["proba"][c] - b["proba"][c]) for c in CLASSES)


def check_answer(r: dict, what: str) -> None:
    p = np.array([r["proba"][c] for c in CLASSES])
    check(r["label"] in CLASSES and np.isfinite(p).all() and abs(p.sum() - 1) < 1e-5,
          f"{what}: bad answer {r}")


def spread(values: list) -> dict:
    return {"median": statistics.median(values), "min": min(values), "max": max(values),
            "n": len(values)}


def stream_phase(pred, y, kernels, what: str, passes: int = STREAM_PASSES) -> dict:
    """One warm pass of predict_stream over `y`, then `passes` timed ones,
    the first of them counted: windows/s of each pass (median, min, max),
    the launches of one pass, and the geometry of the windows."""
    import torch

    pred.predict_stream(y, SR)
    torch.cuda.synchronize()
    rates = []
    for i in range(passes):
        if i == 0:
            launch_counts(reset=True)
        t0 = time.perf_counter()
        wins = pred.predict_stream(y, SR)
        rates.append(len(wins) / (time.perf_counter() - t0))
        if i == 0:
            launches = launch_counts(reset=True)
    check_launched(launches, kernels, what)
    starts = list(range(0, len(y) - 24064, SR))  # 3 s windows (48128 samples), 1 s hop
    check(len(wins) == len(starts), f"{what}: {len(wins)} windows for {len(starts)} starts")
    for k, w in enumerate(wins):
        check_answer(w, what)
        check(abs(w["start_s"] - k) <= 256 / SR + 1e-9, f"{what}: window {k} starts at {w}")
    return {"windows": len(wins), "windows_per_s": spread(rates), "launches_one_pass": launches}


def http_phase(dev, out_dir: str, clips, direct: list, stream_clip, stream_direct) -> dict:
    """The port's HTTP service in-process on a free port, micro-batching on
    (5 ms): /healthz; 8 concurrent /predict?model=ensemble beside one
    /stream?model=ensemble, each answer equal to the direct call; then
    requests/s over HTTP_BURSTS bursts of 8.  The launch counts are set to
    0 after the server's warmup, just before the first request, and read
    just after the last."""
    import concurrent.futures
    import urllib.request

    from stutter_tpu_torch.infer import EnsemblePredictor
    from stutter_tpu_torch.io.wav import write_wav
    from stutter_tpu_torch.serve import serve

    def wav_bytes(y):
        path = os.path.join(out_dir, "upload.wav")
        write_wav(path, y, SR, subtype="FLOAT")  # the samples exactly
        with open(path, "rb") as f:
            return f.read()

    def post(base, path, data):
        req = urllib.request.Request(base + path, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    t0 = time.perf_counter()
    httpd = serve(out_dir, port=0, ensemble=True, batch_window_ms=5.0, device=str(dev))
    start_s = time.perf_counter() - t0
    uploads = [wav_bytes(y) for y in clips]
    stream_upload = wav_bytes(stream_clip)
    sizes = []
    batch = EnsemblePredictor.predict_batch

    def counted(self, clips, *a, **k):
        sizes.append(len(clips))
        return batch(self, clips, *a, **k)

    EnsemblePredictor.predict_batch = counted
    pool = concurrent.futures.ThreadPoolExecutor(len(uploads) + 1)
    try:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_port}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        check(health["models"] == ["ensemble", "mlp"] and health["classes"] == list(CLASSES),
              f"healthz {health}")
        launch_counts(reset=True)
        stream = pool.submit(post, base, "/stream?model=ensemble", stream_upload)
        futs = [pool.submit(post, base, "/predict?model=ensemble", u) for u in uploads]
        answers = [f.result() for f in futs]
        wins = stream.result()
        for a, d in zip(answers, direct):
            check(a["label"] == d["label"] and proba_diff(a, d) < 1e-5,
                  f"http answer {a} != direct {d}")
        check(len(wins) == len(stream_direct) and all(
            w["start_s"] == d["start_s"] and w["label"] == d["label"] and proba_diff(w, d) < 1e-5
            for w, d in zip(wins, stream_direct)), "http /stream != direct predict_stream")
        first_sizes = list(sizes)
        rates = []
        for _ in range(HTTP_BURSTS):
            t0 = time.perf_counter()
            for f in [pool.submit(post, base, "/predict?model=ensemble", u) for u in uploads]:
                check_answer(f.result(), "http burst")
            rates.append(len(uploads) / (time.perf_counter() - t0))
        launches = launch_counts(reset=True)
    finally:
        EnsemblePredictor.predict_batch = batch
        httpd.shutdown()
        httpd.server_close()
        pool.shutdown()
    return {"server_start_s": start_s, "requests_per_s": spread(rates), "launches": launches,
            "batch_sizes_first_burst": first_sizes, "batch_sizes_bursts": sizes[len(first_sizes):]}


def headline_phase(rng, dev, out_dir: str) -> dict:
    """Phase 7: the quint behind EnsemblePredictor on the card, per clip,
    per batch, over streams and behind the HTTP service."""
    import torch

    from stutter_tpu_torch.infer import EnsemblePredictor, Predictor

    write_quint(rng, out_dir, dev)
    t0 = time.perf_counter()
    ens = EnsemblePredictor.load(out_dir, device=dev)
    ens.warmup()
    res = {"load_and_warmup_s": time.perf_counter() - t0}
    clips = [structured_clips(rng, 1, int(d * SR))[0] for d in REQUEST_S]

    launch_counts(reset=True)
    latencies, direct = [], []
    for y in clips:
        t0 = time.perf_counter()
        direct.append(ens.predict_clip(y))
        latencies.append((time.perf_counter() - t0) * 1e3)
    res["launches_predict_clip"] = launch_counts(reset=True)
    check_launched(res["launches_predict_clip"], ["spectral_gate", "spectromel_mel"], "ensemble")
    for r in direct:
        check_answer(r, "ensemble predict_clip")
        check(sorted(r["members"]) == sorted(QUINT), f"members {sorted(r['members'])}")
    res.update(p50_ms=statistics.median(latencies), latencies_ms=latencies,
               labels=[r["label"] for r in direct])

    # the first pass at B=8 builds the library's per-shape plans, the rest
    # reuse them
    batch_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = ens.predict_batch(clips)
        batch_ms.append((time.perf_counter() - t0) * 1e3 / len(clips))
    res["launches_predict_batch"] = launch_counts(reset=True)
    check_launched(res["launches_predict_batch"], ["spectral_gate", "spectromel_mel"],
                   "ensemble predict_batch")
    res.update(batch_ms_per_clip=statistics.median(batch_ms[1:]),
               batch_ms_per_clip_first=batch_ms[0])
    res["batch_vs_clip_max_diff"] = max(proba_diff(a, b) for a, b in zip(batch, direct))
    check(res["batch_vs_clip_max_diff"] < 1e-5 and all(
        a["label"] == b["label"] for a, b in zip(batch, direct)),
        f"predict_batch != predict_clip: {res['batch_vs_clip_max_diff']}")

    cpu = EnsemblePredictor.load(out_dir, device="cpu")
    res["cuda_vs_cpu_max_proba_diff"] = 0.0
    for y, d in zip(clips[1:3], direct[1:3]):
        c = cpu.predict_clip(y)
        res["cuda_vs_cpu_max_proba_diff"] = max(res["cuda_vs_cpu_max_proba_diff"], proba_diff(d, c))
        check(d["label"] == c["label"] and proba_diff(d, c) < 1e-3, f"cuda vs cpu: {d} {c}")

    # the streams: 70 s crosses a segment boundary (1,000,448 samples of
    # window starts a segment), then 8 s in 96,256-sample segments vs the CPU
    mlp = Predictor.load(out_dir, device=dev)
    long = structured_clips(rng, 1, 70 * SR)[0]
    res["stream_vote"] = stream_phase(ens, long, ["spectral_gate", "spectromel_mel"],
                                      "ensemble stream")
    res["stream_mlp"] = stream_phase(mlp, long, ["spectromel", "chroma_stats"], "mlp stream")
    short = structured_clips(rng, 1, 8 * SR)[0]
    res["stream_cuda_vs_cpu_max_proba_diff"] = {}
    for name, (g, c) in {"vote": (ens, cpu), "mlp": (mlp, Predictor.load(out_dir, device="cpu"))
                         }.items():
        a, b = g.predict_stream(short, SR, seg_samples=1 << 16), c.predict_stream(
            short, SR, seg_samples=1 << 16)
        diff = max(proba_diff(x, z) for x, z in zip(a, b))
        check(len(a) == len(b) == 7 and all(x["start_s"] == z["start_s"] and x["label"] == z[
            "label"] for x, z in zip(a, b)) and diff < 1e-3, f"{name} stream cuda vs cpu {diff}")
        res["stream_cuda_vs_cpu_max_proba_diff"][name] = diff
    launch_counts(reset=True)

    stream_clip = structured_clips(rng, 1, 12 * SR)[0]
    stream_direct = ens.predict_stream(stream_clip, SR)
    res["http"] = http_phase(dev, out_dir, clips, direct, stream_clip, stream_direct)
    res["launches_http"] = res["http"].pop("launches")
    check_launched(res["launches_http"], ["spectral_gate", "spectromel_mel"], "http")
    res["profile_request"] = device_profile(lambda: ens.predict_clip(clips[1]))
    return res


def corpus_clip(rng, n: int, sr: int) -> np.ndarray:
    """A recording-like clip: a background noise floor that never stops, and
    one to three partials, gated on and off in a third of the clips."""
    t = np.arange(n) / sr
    y = rng.randn(n) * rng.uniform(0.005, 0.05)
    tones = np.zeros(n)
    for _ in range(rng.randint(1, 4)):
        tones += rng.uniform(0.1, 0.5) * np.sin(2 * np.pi * rng.uniform(80, 3500) * t
                                                 + rng.uniform(0, 2 * np.pi))
    if rng.randint(3) == 0:
        tones *= (t % rng.uniform(0.2, 0.6)) < 0.15
    return (y + tones).astype(np.float32)


def train_clip(rng, i: int, n: int, sr: int) -> np.ndarray:
    """The training corpus's clip i, whose class (i % 3) sets the content
    over a quiet noise floor: steady tones, the same tones gated on and
    off, or bursts of noise."""
    t = np.arange(n) / sr
    y = rng.randn(n) * rng.uniform(0.005, 0.03)
    gate = (t % rng.uniform(0.2, 0.6)) < 0.15
    if i % 3 == 2:
        return (y + rng.randn(n) * rng.uniform(0.1, 0.3) * gate).astype(np.float32)
    tones = sum(rng.uniform(0.1, 0.5) * np.sin(2 * np.pi * rng.uniform(150, 1500) * t
                                               + rng.uniform(0, 2 * np.pi))
                for _ in range(rng.randint(1, 4)))
    return (y + tones * (gate if i % 3 == 1 else 1.0)).astype(np.float32)


def write_corpus(rng, root: str, n_clips: int,
                 clip=lambda rng, i, n, sr: corpus_clip(rng, n, sr)) -> int:
    """n_clips clips of 0.5-10 s under three class folders (clip i in
    CLASSES[i % 3]), unique stems (the feature cache is keyed by stem), ~5 %
    at 22.05 kHz; -> seconds of audio written."""
    from stutter_tpu_torch.io.wav import write_wav

    total = 0.0
    for i in range(n_clips):
        d = os.path.join(root, "segrigated_samples", CLASSES[i % 3])
        os.makedirs(d, exist_ok=True)
        sr = 22050 if rng.rand() < 0.05 else SR
        dur = rng.uniform(0.5, 10.0)
        write_wav(os.path.join(d, f"clip_{i:04d}.wav"), clip(rng, i, int(dur * sr), sr), sr)
        total += dur
    return total


def corpus_phase(rng, dev, root: str) -> dict:
    """preprocess, then extract_corpus for both variants and both suffixes,
    on the card, each timed; then 8 sampled rows of each against the CPU's
    plain path on the same audio."""
    import logging

    import torch

    from stutter_tpu_torch.config import FEATURES_334, PipelineConfig
    from stutter_tpu_torch.utils.profiling import StageTimer
    from stutter_tpu_torch.io.decode import decode_audio
    from stutter_tpu_torch.ops.frontend import extract_features_numpy
    from stutter_tpu_torch.pipeline import extract_corpus, preprocess

    cfgs = {149: PipelineConfig(), 286: PipelineConfig(features=FEATURES_334)}
    t0 = time.perf_counter()
    seconds = write_corpus(rng, root, N_CORPUS)
    print(f"corpus: {N_CORPUS} clips, {seconds:.0f} s of audio written in "
          f"{time.perf_counter() - t0:.1f} s")

    # the entry points' own per-stage reports (StageTimer.log_report)
    reports: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda record: reports.append(record.getMessage())
    prof_log = logging.getLogger("stutter_tpu_torch.profiling")
    prof_log.addHandler(handler)
    prof_log.setLevel(logging.INFO)

    timer, out = StageTimer(), {}
    launch_counts(reset=True)
    with timer.stage("preprocess"):
        rows = preprocess(root, cfgs[149], device=dev)
    launches = {"preprocess": launch_counts(reset=True)}
    check(len(rows) == N_CORPUS, f"preprocess wrote {len(rows)} rows")
    for dim, cfg in cfgs.items():
        for sfx in ("raw", "clean"):
            with timer.stage(f"extract_{dim}_{sfx}"):
                out[dim, sfx] = extract_corpus(root, cfg, sfx, device=dev)
            launches[f"extract_{dim}_{sfx}"] = launch_counts(reset=True)
    prof_log.removeHandler(handler)
    check_launched(launches["preprocess"], ["spectral_gate"], "preprocess")
    for sfx in ("raw", "clean"):
        check_launched(launches[f"extract_149_{sfx}"], ["spectromel", "chroma_stats"], "extract 149")
        check_launched(launches[f"extract_286_{sfx}"], ["spectromel_mel"], "extract 286")

    cache = os.path.join(root, cfgs[149].data.cache_dir)
    names = os.listdir(cache)
    rates = {k: N_CORPUS / v for k, v in timer.totals.items()}
    res = {"clips": N_CORPUS, "audio_s": seconds, "clips_per_s": rates, "launches": launches,
           "stage_reports": reports}
    for (dim, sfx), (X, labels, files, ok) in out.items():
        check(X.shape == (N_CORPUS, dim) and bool(ok.all()) and np.isfinite(X).all(),
              f"extract {dim} {sfx}: shape {X.shape}, {int((~ok).sum())} rows not ok")
        tag = "" if dim == 149 else "_d286"
        n_cached = sum(n.endswith(f"_{sfx}_feats{tag}.npy") for n in names)
        check(n_cached == N_CORPUS, f"{n_cached} cache files *_{sfx}_feats{tag}.npy")
        check(sorted(set(labels)) == sorted(CLASSES), f"labels {sorted(set(labels))}")

    # 8 sampled rows of each run through the CPU's plain path
    sample = rng.choice(N_CORPUS, 8, replace=False)
    errs = {}
    for (dim, sfx), (X, _, files, _) in out.items():
        paths = [files[i] if sfx == "raw" else os.path.join(
            root, cfgs[dim].data.clear_dir, os.path.splitext(os.path.basename(files[i]))[0] + ".wav")
            for i in sample]
        clips = [decode_audio(p, SR, device="cpu") for p in paths]
        ref = extract_features_numpy(clips, cfgs[dim].features, device="cpu")
        e = np.abs(X[sample] - ref)
        if dim == 149:
            errs[dim, sfx] = {"mfcc": float(e[:, :120].max()), "chroma": float(e[:, 120:144].max())}
            ok = errs[dim, sfx]["mfcc"] < 2e-3 and errs[dim, sfx]["chroma"] < 1e-5
        else:
            # bounds of tests/test_torch_frontend334.py, except contrast: the
            # card's power (chunk-DFT GEMM) and the CPU's (rfft) round
            # differently, and a band's valley is its quietest bins, where
            # that rounding weighs most -- in denoised clips most of all
            # (up to 1.6e-3 dB measured on an H100); held to 1e-2 dB per band
            lim = 1e-3 + 2e-6 * np.abs(ref)
            contrast = e[:, 264:278].max(axis=0)
            errs[dim, sfx] = {"mfcc_chroma_over_bound": float((e[:, :264] / lim[:, :264]).max()),
                              "contrast_per_band": [float(v) for v in contrast],
                              "scalars_over_bound": float((e[:, 278:] / (1e-3 + 1e-6 * np.abs(
                                  ref[:, 278:]))).max())}
            ok = (errs[dim, sfx]["mfcc_chroma_over_bound"] < 1 and contrast.max() < 1e-2
                  and errs[dim, sfx]["scalars_over_bound"] < 1)
        errs[dim, sfx]["ok"] = bool(ok)
    res["sampled_rows_vs_cpu"] = {f"{d}_{s}": v for (d, s), v in errs.items()}
    torch.cuda.synchronize()
    return res


# the files the JAX package's run_cv (include_host=False) and
# run_before_after write on a 3-class corpus without sklearn, and each
# CSV's header (None: not a CSV)
CM_HEADER = "," + ",".join(CLASSES)
RUN_CV_FILES = {
    "FINAL_PERFORMANCE_TABLE.csv": "Model,Accuracy (%),Precision (%),Recall (%),F1-Score (%)",
    "permutation_importance_mlp_tpu.csv": "feature,importance,std",
    "confusion_MLP-TPU.csv": CM_HEADER,
    **dict.fromkeys(("final_performance.html", "permutation_importance_mlp_tpu.html",
                     "confusion_matrices.html", "scaler_after.npz", "label_encoder.json",
                     "model_mlp_tpu.npz", "model_mlp_tpu.json")),
}
ENGINE_A_FILES = {
    "train_test_sizes.csv": "dataset,train_size,test_size",
    "metrics_summary.csv": "dataset,model,accuracy,test_loss",
    "metrics_summary.html": None,
    **{k: v for s in ("before", "after") for k, v in {
        f"confusion_{s}_MLP-TPU.csv": CM_HEADER,
        f"class_report_{s}_MLP-TPU.csv": ",precision,recall,f1-score,support",
        f"auc_{s}.csv": "model,class,auc",
        f"roc_{s}.csv": "model,class,fpr,tpr,threshold",
        f"roc_{s}.html": None, f"confusion_{s}.html": None}.items()},
}


def check_files(out_dir: str, files: dict, what: str) -> None:
    for name, header in files.items():
        path = os.path.join(out_dir, name)
        check(os.path.exists(path), f"{what}: {name} not written")
        if header is not None:
            with open(path) as f:
                got = f.readline().rstrip("\n")
            check(got == header, f"{what}: {name} header {got!r} != {header!r}")


def step_errors(a: np.ndarray, b: np.ndarray) -> dict:
    """The normwise relative error |a - b| / |b| of a trained tensor (the
    bound), the largest element's error over the tensor's largest value,
    and how many elements differ by more than 1e-4 of that value.  Element
    by element, a few Adam steps are ill-conditioned: where an element's
    loss gradient nearly cancels its weight decay (wd * p), the sum left is
    of the order of Adam's eps (1e-8), so rounding in the gradient changes
    the size of the first update, lr * g / (|g| + eps), by a large share
    (`worst_element` reads it)."""
    d = np.abs(a - b)
    return {"rel": float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            "max_elem_rel": float(d.max() / np.abs(b).max()),
            "n_elem_over_1e-4": int((d > 1e-4 * np.abs(b).max()).sum()), "n": int(a.size)}


ADAM_EPS = 1e-8  # torch.optim.Adam's and optax.adam's default eps
FED_SCHEDULE = 1000  # the cosine schedule's length in fed_steps


def worst_element(card: tuple, cpu: tuple, init: dict, cfg) -> dict:
    """The trained element whose card value differs most from the CPU's
    (over its tensor's largest value), from each device's chained fed steps
    (params, grads, as numpy) and the initial params: its initial and final
    values, its loss gradient at every step on both devices beside the
    largest of its tensor's, and on each device the first step's gradient
    with the weight decay added (what Adam normalises) and the update it
    gives, -lr * g / (|g| + eps)."""
    from stutter_tpu_torch.train.trainer import learning_rate

    (p_card, g_card), (p_cpu, g_cpu) = card, cpu
    k = max(p_cpu, key=lambda k: np.abs(p_card[k] - p_cpu[k]).max() / np.abs(p_cpu[k]).max())
    i = np.unravel_index(np.abs(p_card[k] - p_cpu[k]).argmax(), p_cpu[k].shape)
    p0 = float(init[k][i])
    out = {"tensor": k, "index": [int(v) for v in i], "init": p0, "card": float(p_card[k][i]),
           "cpu": float(p_cpu[k][i]), "grad_card": [float(g[k][i]) for g in g_card],
           "grad_cpu": [float(g[k][i]) for g in g_cpu],
           "tensor_grad_max": [float(np.abs(g[k]).max()) for g in g_cpu]}
    for dev, grads in (("card", g_card), ("cpu", g_cpu)):
        g = float(grads[0][k][i]) + cfg.weight_decay * p0
        out[f"decayed_grad0_{dev}"] = g
        out[f"first_update_{dev}"] = -learning_rate(0, FED_SCHEDULE, cfg) * g / (abs(g) + ADAM_EPS)
    return out


def fed_batch(X, y, idx, keeps, t: int, dev, dtype=None) -> tuple:
    """Step t's fed batch on `dev`, the arguments of GridTrainer.step: rows
    idx[t] [G, B] of X [G, N, D] and y [G, N], unit sample weights and the
    keep-masks keeps[t]; X and the weights in `dtype` (FP32 by default)."""
    import torch

    dtype = dtype or torch.float32
    rows = np.arange(X.shape[0])[:, None]
    return (torch.from_numpy(X[rows, idx[t]]).to(dev, dtype),
            torch.from_numpy(y[rows, idx[t]]).to(dev),
            torch.ones(idx.shape[1], idx.shape[2], device=dev, dtype=dtype),
            [torch.from_numpy(k).to(dev) for k in keeps[t]])


def named_tensors(tr) -> list:
    """A GridTrainer's (name, parameter) pairs in its optimizer's order."""
    return ([(f"w{i}", w) for i, w in enumerate(tr.weights)]
            + [(f"b{i}", b) for i, b in enumerate(tr.biases)])


def fed_steps(dev, X, y, idx, keeps, seeds, cfg) -> tuple:
    """FP32 GridTrainer steps from init_grid(seeds) on `dev`, each step's
    batch rows idx[t] [G, B] of X [G, N, D] / y [G, N] and keep-masks
    keeps[t] fed (`fed_batch`) -> the trainer, and each step's loss
    gradients as numpy."""
    from stutter_tpu_torch.train.trainer import GridTrainer, init_grid

    tr = GridTrainer(init_grid(seeds, X.shape[-1], cfg, dev), cfg, FED_SCHEDULE)
    grads = []
    for t in range(len(idx)):
        tr.step(*fed_batch(X, y, idx, keeps, t, dev))
        grads.append({k: p.grad.cpu().numpy() for k, p in named_tensors(tr)})
    return tr, grads


# The fed-step check (phase 8).  Ten chained FP32 steps, card against CPU,
# are ill-conditioned: a pre-activation within FP32 rounding of zero flips a
# ReLU gate on one device and not the other, and the chain carries it.  So
# each step is held on its own, from the state of an FP64 run of the same
# steps, to FP64: the loss and gradients with the card's own sign at the
# gates that rounding decides, then Adam's update given the card's gradient.
FED_BOUNDS = {"grad": 1e-4, "update": 1e-4, "loss": 1e-5}  # per entry, per tensor, normwise
GATE_LAMBDA = 6.0  # gate_bounds: the probabilistic bound's lambda
GATE_SHARE = 0.01  # the most rounding-decided gates an entry-step may hold, of all its gates
U32 = 2.0 ** -24  # FP32's unit roundoff
# A gradient that cancels to less than GRAD_FLOOR of its terms' sum (fp64_loss_and_grads'
# scale, |h|^T |dz| and sum |dz| over the batch) has its error taken over GRAD_FLOOR * |scale|:
# FP32's error is a share of the terms (0.3-2.7 u of |scale| on the CPU), so |grad| alone makes
# it grow without limit as the sum cancels.  b3's, a batch mean of softmax minus target, cancels
# to 0.005-0.012 of its scale on the CPU; every other tensor's stays above 0.12, so is held to
# its own norm as before.
GRAD_FLOOR = 0.1


def card_preactivations(weights, biases, x, keeps, dropout: float) -> list:
    """apply_mlp_grid's chain (baddbmm, ReLU, dropout's keep and scale) ->
    every layer's pre-activation z [G, B, d_out], the logits last."""
    import torch

    zs, h = [], x
    for i, (w, b) in enumerate(zip(weights, biases)):
        zs.append(torch.baddbmm(b.unsqueeze(1), h, w))
        if i < len(weights) - 1:
            h = torch.where(keeps[i], torch.relu(zs[-1]) / (1.0 - dropout), 0.0)
    return zs


def step_from(ref, dev, batch, cfg) -> dict:
    """Step t of an FP32 GridTrainer on `dev` from the state of `ref` (an
    FP64 GridTrainer before step t): its parameters and Adam's moments
    rounded to FP32 (Adam's state only: the trainer keeps its own
    hyperparameters), steps_done = t.  -> the start (the rounded parameters
    and moments, as float64 on the CPU), each entry's loss, the loss
    gradients and the new parameters, the sign of every hidden
    pre-activation (the same baddbmm chain recomputed, checked bitwise
    against a second run and against the model's forward)."""
    import copy

    import torch

    from stutter_tpu_torch.models.mlp import apply_mlp_grid
    from stutter_tpu_torch.train import trainer

    def f64(v):
        return v.detach().to("cpu", torch.float64, copy=True)

    tr = trainer.GridTrainer({k: v.to(dev, torch.float32) for k, v in ref.params().items()},
                             cfg, FED_SCHEDULE)
    sd = tr.opt.state_dict()
    sd["state"] = copy.deepcopy(ref.opt.state_dict()["state"])
    tr.opt.load_state_dict(sd)
    tr.steps_done = ref.steps_done
    x, y, w, keeps = batch
    with torch.no_grad():
        zs = card_preactivations(tr.weights, tr.biases, x, keeps, cfg.dropout)
        again = card_preactivations(tr.weights, tr.biases, x, keeps, cfg.dropout)
        logits = apply_mlp_grid(tr.weights, tr.biases, x, keeps, cfg.dropout)
        loss = trainer.grid_losses(tr.weights, tr.biases, x, y, w, keeps, tr.cfg)
    named = named_tensors(tr)
    start = {"params": {k: f64(p) for k, p in named},
             "adam": {i: {k: v.clone() if k == "step" else f64(v)
                          for k, v in tr.opt.state[p].items()}
                      for i, (_, p) in enumerate(named) if tr.opt.state[p]}}
    tr.step(x, y, w, keeps)
    return {"start": start, "loss": f64(loss), "grads": {k: f64(p.grad) for k, p in named},
            "params": {k: f64(p) for k, p in named},
            "gates": [(z > 0).cpu() for z in zs[:-1]],
            "bitwise": all(torch.equal(a, b) for a, b in zip(zs, again))
            and torch.equal(zs[-1], logits)}


def gate_bounds(params: dict, x, keeps, dropout: float) -> tuple[list, list]:
    """FP64 from `params` (float64): every hidden layer's pre-activation z
    and a bound on FP32's error in it.  A layer's n = d_in + 1 term dot
    product errs by at most GATE_LAMBDA * sqrt(n) * u * (|h| @ |W| + |b|)
    with probability >= 1 - 2n exp(-GATE_LAMBDA**2 / 2) (Higham and Mary's
    probabilistic bound, 2019: > 1 - 1e-5 at n <= 257 and lambda 6).  The
    FP32 input h carries its layer's bound and the dropout scale's rounding
    (2u |z| / (1 - p)) forward, as independent errors are carried through a
    sum: sqrt(err_h**2 @ W**2)."""
    import torch

    n = len(params) // 2
    h, err_h, zs, bounds = x, torch.zeros_like(x), [], []
    for i in range(n - 1):
        w, b = params[f"w{i}"], params[f"b{i}"]
        z = torch.baddbmm(b.unsqueeze(1), h, w)
        e = (GATE_LAMBDA * math.sqrt(w.shape[1] + 1) * U32
             * torch.baddbmm(b.abs().unsqueeze(1), h.abs(), w.abs())
             + torch.bmm(err_h.square(), w.square()).sqrt())
        zs.append(z)
        bounds.append(e)
        h = torch.where(keeps[i], torch.relu(z) / (1.0 - dropout), 0.0)
        err_h = torch.where(keeps[i], (e + 2 * U32 * z.abs()) / (1.0 - dropout), 0.0)
    return zs, bounds


def fp64_loss_and_grads(params: dict, x, y, keeps, gates: list, cfg) -> tuple:
    """The fed step's loss per entry [G] and its gradients in FP64, written
    apart from the trainer: each hidden layer's ReLU as z * gate with the
    0/1 `gates` held constant, dropout's keep and 1/(1 - p) scale,
    label-smoothed cross-entropy averaged over the batch (the fed sample
    weights are all 1), the entries' losses summed.  Also each gradient's
    scale: the same backward pass over absolute values, |softmax - target|
    taken as softmax + target, so that no sum in it cancels (a tensor's
    gradient is a sum over the batch, and b3's, a batch mean of softmax
    minus target, can cancel to far below its terms)."""
    import torch

    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    n = len(p) // 2
    hs, zs, h = [], [], x
    for i in range(n):
        hs.append(h.detach())
        zs.append(torch.baddbmm(p[f"b{i}"].unsqueeze(1), h, p[f"w{i}"]))
        zs[-1].retain_grad()
        h = zs[-1]
        if i < n - 1:
            h = torch.where(keeps[i], h * gates[i] / (1.0 - cfg.dropout), 0.0)
    n_cls = h.shape[-1]
    target = (torch.nn.functional.one_hot(y, n_cls).to(h.dtype) * (1.0 - cfg.label_smoothing)
              + cfg.label_smoothing / n_cls)
    loss = -(target * torch.log_softmax(h, -1)).sum(-1).mean(-1)
    loss.sum().backward()
    scale = {}
    for i, (h, z) in enumerate(zip(hs, zs)):
        scale[f"w{i}"] = torch.bmm(h.abs().transpose(1, 2), z.grad.abs())
        scale[f"b{i}"] = z.grad.abs().sum(1)
    return loss.detach(), {k: v.grad for k, v in p.items()}, scale


def adam_reference(start: dict, grads: dict, t: int, cfg) -> dict:
    """torch.optim.Adam in FP64 from the card's start (its rounded
    parameters and moments) given the card's gradients at step t, at the
    schedule's rate, with L2 decay added to the gradient -> each tensor's
    update."""
    import copy

    import torch

    from stutter_tpu_torch.train.trainer import learning_rate

    p = {k: v.clone().requires_grad_(True) for k, v in start["params"].items()}
    opt = torch.optim.Adam(list(p.values()), lr=learning_rate(t, FED_SCHEDULE, cfg),
                           weight_decay=cfg.weight_decay)
    sd = opt.state_dict()
    sd["state"] = copy.deepcopy(start["adam"])
    opt.load_state_dict(sd)
    for k, v in p.items():
        v.grad = grads[k].clone()
    opt.step()
    return {k: v.detach() - start["params"][k] for k, v in p.items()}


def entry_errors(a: dict, b: dict, scale: dict | None = None) -> dict:
    """Each grid entry's normwise relative error |a - b| / |b|, by tensor
    ({name: [G, ...]} -> {name: [G]}); with `scale`, over max(|b|,
    GRAD_FLOOR * |scale|).  An error that is not a number (a NaN in `a`)
    reads inf."""
    import torch

    out = {}
    for k, ref in b.items():
        dims = tuple(range(1, ref.dim()))
        den = ref.norm(dim=dims)
        if scale is not None:
            den = torch.maximum(den, GRAD_FLOOR * scale[k].norm(dim=dims))
        out[k] = np.nan_to_num(((a[k] - ref).norm(dim=dims) / den).numpy(), nan=np.inf)
    return out


def check_fed_step(card: dict, batch, t: int, cfg) -> dict:
    """Step t of the card (`step_from`) against FP64 on the fed batch
    (float64 on the CPU): the gates whose FP64 pre-activation lies within
    FP32's error bound of zero are rounding-decided and take the card's
    sign, every other gate FP64's own; the loss per entry (relative),
    the gradients (per entry and tensor, normwise, over GRAD_FLOOR of their
    scale where they cancel below it) and Adam's update given the card's
    gradient (per entry and tensor, normwise) against FED_BOUNDS; the share
    of rounding-decided gates against GATE_SHARE; an error that is not a
    number, and any value of the card's that is not finite, fail -> the
    step's worst errors, its flagged and flipped gates, and the grid
    entries over each bound."""
    import torch

    x, y, _, keeps = batch
    zs, bounds = gate_bounds(card["start"]["params"], x, keeps, cfg.dropout)
    # rounding-decided gates of kept units (a dropped unit's gate decides nothing)
    flagged = [(z.abs() <= e) & k for z, e, k in zip(zs, bounds, keeps)]
    own = [z > 0 for z in zs]
    gates = [torch.where(f, c, o).to(x.dtype) for f, c, o in zip(flagged, card["gates"], own)]
    loss, grads, scale = fp64_loss_and_grads(card["start"]["params"], x, y, keeps, gates, cfg)
    flipped = sum(int((f & (c != o)).sum()) for f, c, o in zip(flagged, card["gates"], own))
    errs = {"grad": entry_errors(card["grads"], grads, scale),
            "update": entry_errors({k: v - card["start"]["params"][k]
                                    for k, v in card["params"].items()},
                                   adam_reference(card["start"], card["grads"], t, cfg)),
            "loss": {"loss": np.nan_to_num(((card["loss"] - loss).abs() / loss.abs()).numpy(),
                                           nan=np.inf)}}
    per_entry = sum(f.flatten(1).sum(1) for f in flagged).numpy()
    n_gates = sum(f[0].numel() for f in flagged)
    finite = torch.stack([torch.isfinite(v).flatten(1).all(1) for v in (
        card["loss"].unsqueeze(1), *card["grads"].values(), *card["params"].values())]).all(0)
    res = {"t": t, "flagged": int(per_entry.sum()), "flagged_max_entry": int(per_entry.max()),
           "flipped": flipped, "bitwise": card["bitwise"],
           "over": {"flagged": np.flatnonzero(per_entry > GATE_SHARE * n_gates).tolist(),
                    "finite": np.flatnonzero(~finite.numpy()).tolist()}}
    for part, e in errs.items():
        k = max(e, key=lambda k: e[k].max())
        res[part] = {"max": float(e[k].max()), "tensor": k, "entry": int(e[k].argmax())}
        res["over"][part] = sorted({int(g) for v in e.values()
                                    for g in np.flatnonzero(~(v < FED_BOUNDS[part]))})
    normwise = entry_errors(card["grads"], grads)  # |grad| alone: a diagnostic
    k = max(normwise, key=lambda k: normwise[k].max())
    res["grad_normwise"] = {"max": float(normwise[k].max()), "tensor": k,
                            "entry": int(normwise[k].argmax())}
    for r in (res["grad"], res["grad_normwise"]):  # |grad| / |scale|: how far it cancels
        r["cancel"] = float(grads[r["tensor"]][r["entry"]].norm()
                            / scale[r["tensor"]][r["entry"]].norm())
    if flipped:  # the plain FP64 gradient, FP64's own sign at every gate: a diagnostic
        plain = entry_errors(card["grads"], fp64_loss_and_grads(
            card["start"]["params"], x, y, keeps, [o.to(x.dtype) for o in own], cfg)[1], scale)
    else:
        plain = errs["grad"]
    res["grad_plain_max"] = float(max(v.max() for v in plain.values()))
    res["ok"] = card["bitwise"] and not any(res["over"].values())
    return res


def check_fed_steps(dev, X, y, idx, keeps, seeds, cfg) -> tuple:
    """The fed steps held one at a time: an FP64 GridTrainer on the CPU
    takes them from init_grid(seeds), and before each of its steps the
    card's step from its state (`step_from`) is held to FP64
    (`check_fed_step`) -> each step's result and the FP64 trainer after the
    last step (the chained reference)."""
    import torch

    from stutter_tpu_torch.train.trainer import GridTrainer, init_grid

    cpu = torch.device("cpu")
    ref = GridTrainer({k: v.double() for k, v in init_grid(seeds, X.shape[-1], cfg, cpu).items()},
                      cfg, FED_SCHEDULE)
    steps = []
    for t in range(len(idx)):
        batch = fed_batch(X, y, idx, keeps, t, cpu, torch.float64)
        card = step_from(ref, dev, fed_batch(X, y, idx, keeps, t, dev), cfg)
        steps.append(check_fed_step(card, batch, t, cfg))
        ref.step(*batch)
    return steps, ref


def fed_step_phase(dev, X, y, idx, keeps, seeds, cfg) -> dict:
    """Phase 8's fed steps: each held to FP64 (`check_fed_steps`), gated;
    then the ten chained steps on the card and on the CPU in FP32, gated
    only on their step counts (every trainer's steps_done and Adam's step
    at len(idx)), with their normwise distances per tensor (card vs CPU,
    each vs the FP64 chain), the grid entry that differs most between card
    and CPU and the element that does (`worst_element`) reported."""
    import torch

    from stutter_tpu_torch.train import trainer

    steps, exact = check_fed_steps(dev, X, y, idx, keeps, seeds, cfg)
    chains = {"card": fed_steps(dev, X, y, idx, keeps, seeds, cfg),
              "cpu": fed_steps(torch.device("cpu"), X, y, idx, keeps, seeds, cfg)}
    n = len(idx)
    counts = {d: [tr.steps_done] + [int(s["step"]) for s in tr.opt.state.values()]
              for d, (tr, _) in chains.items()}
    p = {d: {k: v.cpu().double() for k, v in tr.params().items()} for d, (tr, _) in chains.items()}
    p64 = {k: v.double() for k, v in exact.params().items()}
    chained = {k: {**step_errors(p["card"][k].numpy(), v.numpy()),
                   "card_vs_fp64": step_errors(p["card"][k].numpy(), p64[k].numpy())["rel"],
                   "cpu_vs_fp64": step_errors(v.numpy(), p64[k].numpy())["rel"]}
               for k, v in p["cpu"].items()}
    by_entry = entry_errors(p["card"], p["cpu"])
    worst = max(by_entry, key=lambda k: by_entry[k].max())
    init = {k: v.numpy() for k, v in trainer.init_grid(seeds, X.shape[-1], cfg, "cpu").items()}
    res = {
        "steps": steps, "step_counts_ok": all(c == n for v in counts.values() for c in v),
        "worst": {part: max(s[part]["max"] for s in steps) for part in FED_BOUNDS},
        "flagged_by_step": [s["flagged"] for s in steps],
        "flipped_by_step": [s["flipped"] for s in steps],
        "grad_plain_max": max(s["grad_plain_max"] for s in steps),
        "grad_normwise": max((s["grad_normwise"] for s in steps), key=lambda r: r["max"]),
        "chained": chained,
        "chained_worst_entry": {"tensor": worst, "entry": int(by_entry[worst].argmax()),
                                "rel": float(by_entry[worst].max())},
        "chained_worst_element": worst_element(
            *(({k: v.numpy() for k, v in p[d].items()}, chains[d][1]) for d in ("card", "cpu")),
            init, cfg)}
    res["ok"] = res["step_counts_ok"] and all(s["ok"] for s in steps)
    return res


def training_phase(rng, dev, root: str) -> dict:
    """Phase 8: preprocess, run_cv, run_before_after and run_cv --variant
    334 on the card over a corpus whose class sets the content; the trained
    model served; fed steps against the CPU; a profiled window of steps.
    Each entry point's launches are counted from just before it to just
    after it, and the serving of the trained model's apart from them."""
    import torch

    from stutter_tpu_torch import pipeline
    from stutter_tpu_torch.config import FEATURES_334, PipelineConfig
    from stutter_tpu_torch.models.scaler import StandardScaler
    from stutter_tpu_torch.train import trainer
    from stutter_tpu_torch.train.trainer import MLPTrainConfig, draw_batch, total_steps

    cfgs = {149: PipelineConfig(), 286: PipelineConfig(features=FEATURES_334)}
    out_dir = os.path.join(root, cfgs[149].data.output_dir)
    t0 = time.perf_counter()
    res = {"clips": N_TRAIN, "audio_s": write_corpus(rng, root, N_TRAIN, train_clip),
           "write_s": time.perf_counter() - t0, "launches_by_entry": {}}
    cfg = MLPTrainConfig()

    def counted(name: str, kernels, fn):
        return counted_entry(res["launches_by_entry"], name, kernels, fn)

    def run_cv(dim):
        kernels = ["spectromel", "chroma_stats"] if dim == 149 else ["spectromel_mel"]
        cv, s = counted(f"run_cv_{dim}", kernels, lambda: pipeline.run_cv(
            root, cfgs[dim], include_host=False, device=dev))
        stages = cv["stage_s"]
        check({"mlp_cv", "mlp_fit", "mlp_importance", "single_split_MLP-TPU"} <= set(stages),
              f"run_cv {dim}: stages {stages}")
        n = sum(len(te) for _, te in cv["folds"])
        n_cv = max(len(tr) for tr, _ in cv["folds"])
        res[f"run_cv_{dim}"] = {
            "s": s, "stage_s": stages, "rows": cv["final_rows"],
            "cv_steps_per_s": total_steps(cfg, n_cv) / stages["mlp_cv"],
            "fit_steps_per_s": total_steps(cfg, n) / stages["mlp_fit"]}
        check(cv["final_rows"][0]["Model"] == "MLP-TPU"
              and cv["final_rows"][0]["Accuracy (%)"] >= 90,
              f"run_cv {dim}: MLP-TPU CV accuracy {cv['final_rows']}")
        check_files(out_dir, RUN_CV_FILES, f"run_cv {dim}")

    _, res["preprocess_s"] = counted("preprocess", ["spectral_gate"],
                                     lambda: pipeline.preprocess(root, cfgs[149], device=dev))
    run_cv(149)
    res["serve"] = serve_trained(rng, dev, out_dir, cfgs[149])
    ab, s = counted("run_before_after", ["spectromel", "chroma_stats"],
                    lambda: pipeline.run_before_after(root, cfgs[149], device=dev))
    res["run_before_after"] = {"s": s, "stage_s": ab["stage_s"], "metrics": ab["metrics"]}
    after = {m["model"]: m["accuracy"] for m in ab["metrics"] if m["dataset"] == "after"}
    check(after["MLP-TPU"] >= 90, f"run_before_after: after {ab['metrics']}")
    check_files(out_dir, ENGINE_A_FILES, "run_before_after")
    run_cv(286)
    res["launches"] = {k: sum(c[k] for c in res["launches_by_entry"].values()) for k in KERNELS}
    check_launched(res["launches"], FRONT_END_KERNELS, "training")

    # ten fed steps at full width, G = 40 (the CV grid's shape), card vs CPU
    X, labels, _, _ = pipeline.extract_corpus(root, cfgs[149], "clean", device=dev)
    Xs = StandardScaler.fit(X).transform(X).astype(np.float32)
    y = np.asarray([CLASSES.index(l) for l in labels])
    G, N = 40, len(Xs) * 4 // 5  # the CV grid: 40 entries of 724 training rows
    pick = np.stack([rng.choice(len(Xs), N, replace=False) for _ in range(G)])
    Xg, yg = Xs[pick], y[pick]
    idx = rng.randint(0, N, (10, G, cfg.batch_size))
    keeps = [[rng.rand(G, cfg.batch_size, h) < 1 - cfg.dropout for h in cfg.hidden]
             for _ in range(10)]
    seeds = [cfg.seed + s % cfg.n_seeds for s in range(G)]
    t0 = time.perf_counter()
    res["fed_steps"] = fed_step_phase(dev, Xg, yg, idx, keeps, seeds, cfg)
    res["fed_steps_s"] = time.perf_counter() - t0
    check(res["fed_steps"]["ok"], f"fed steps card vs fp64: {res['fed_steps']}")

    # a profiled window of 20 drawn steps at the CV grid's shape
    tr = trainer.GridTrainer(trainer.init_grid(seeds, Xs.shape[1], cfg, dev), cfg, 1000)
    Xd, yd = torch.from_numpy(Xg).to(dev), torch.from_numpy(yg).to(dev)
    wd = torch.ones(G, N, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    window = 20

    def steps():
        for _ in range(window):
            tr.step(*draw_batch(Xd, yd, wd, cfg, gen))

    prof = device_profile(steps)
    res["profile_steps"] = {**prof, "steps": window, "ms_per_step": prof["wall_ms"] / window,
                            "launches_per_step": prof["launches"] / window}
    return res


def serve_trained(rng, dev, out_dir: str, cfg) -> dict:
    """The trained artifacts behind Predictor.load on the card: the
    8-request mix (REQUEST_S, clips of the training corpus's kinds, denoise
    on); then the same clips without denoise on the card and on the CPU's
    plain path: the same labels, probabilities within 1e-3.  (Denoised, the
    card's gate and the CPU's differ by up to ~1e-2 in a sample, which the
    features carry.)  Its launches are counted from just before the first
    request to just after the last."""
    from stutter_tpu_torch.infer import Predictor

    pred = Predictor.load(out_dir, cfg, device=dev)
    cpu = Predictor.load(out_dir, cfg, device="cpu")
    clips = [train_clip(rng, i, int(d * SR), SR) for i, d in enumerate(REQUEST_S)]
    launch_counts(reset=True)
    answers = [pred.predict_clip(y) for y in clips]
    for r in answers:
        check_answer(r, "trained predict_clip")
    diff = 0.0
    for y in clips:
        a, b = pred.predict_clip(y, denoise=False), cpu.predict_clip(y, denoise=False)
        diff = max(diff, proba_diff(a, b))
        check(a["label"] == b["label"] and diff < 1e-3, f"trained model cuda vs cpu: {a} {b}")
    launches = launch_counts(reset=True)
    check_launched(launches, ["spectromel", "chroma_stats", "spectral_gate"], "trained model served")
    return {"launches": launches, "labels": [r["label"] for r in answers],
            "true": [CLASSES[i % 3] for i in range(len(clips))],
            "cuda_vs_cpu_max_proba_diff": diff}


# the files run_cv(include_seq=True) adds to RUN_CV_FILES, and each CSV's header
SEQ_FILES = {"oof_probas.npz": None, "ensemble_weights.json": None, "ensemble.json": None,
             **{f"model_{a}{s}": None for a in QUINT for s in (".npz", "_norm.npz", ".json")}}
SEQ_KERNELS = ("spectromel", "chroma_stats", "spectromel_mel")


def seq_grid_parts(arch: str, dev, X, nv, y, G: int, cfg, n_steps: int):
    """A grid of G entries of `arch` at its published widths (init seeds
    cfg.seed + g), its trainer, and its steps' inputs on `dev`: the frames
    X [N, T, D] standardized by one set of stats, every row in every
    entry's sample, each entry's draws from draw_steps(cfg.seed + g)."""
    from stutter_tpu_torch.train.seq_pipeline import ARCHS
    from stutter_tpu_torch.train.seq_trainer import (
        GridSteps, SeqGrid, SeqGridTrainer, draw_steps, row_targets, standardize_sequences)

    spec = ARCHS[arch]
    _, mean, std = standardize_sequences(X, nv)
    seeds = [cfg.seed + g for g in range(G)]
    grid = SeqGrid(spec["module"], [spec["init_fn"](np.random.RandomState(s),
                                                    **spec["init_kwargs"](len(CLASSES)))
                                    for s in seeds], dev)
    draws = [draw_steps(s, np.ones(len(y)), nv, n_steps, cfg, X.shape[2]) for s in seeds]
    steps = GridSteps(X, nv, row_targets(y, len(CLASSES), cfg), np.stack([mean] * G),
                      np.stack([std] * G), draws, seeds, cfg, dev)
    return grid, SeqGridTrainer(grid, cfg, FED_SCHEDULE), steps


def seq_fed_steps(dev, arch: str, X, nv, y, cfg, n_steps: int = 5, dtype=None) -> dict:
    """n_steps of the CV grid's shape (G = 5) on `dev`, the draws fed, in
    FP32 (or in `dtype`, weights, data and mixup's lam cast) -> the grid's
    weights by tensor, [G, ...] numpy in the JAX layout, as float64."""
    grid, trainer, steps = seq_grid_parts(arch, dev, X, nv, y, 5, cfg, n_steps)
    if dtype is not None:
        grid.models.to(dtype)
        steps.X, steps.mean, steps.std, steps.targets = (
            t.to(dtype) for t in (steps.X, steps.mean, steps.std, steps.targets))
        if "lam" in steps.draws:
            steps.draws["lam"] = steps.draws["lam"].to(dtype)
    for t in range(n_steps):
        trainer.step(*steps.batch(t))
    params = grid.params()
    return {k: np.stack([p[k] for p in params]).astype(np.float64) for k in params[0]}


def seq_training_phase(rng, dev, root: str) -> dict:
    """Phase 9: run_cv with the quint on the card over phase 8's corpus,
    the trained vote served, fed steps and a checkpoint resume against
    references, a profiled window of grid steps, peak memory.  Each entry
    point's launches are counted from just before it to just after it."""
    import shutil

    import torch

    from stutter_tpu_torch import pipeline
    from stutter_tpu_torch.config import PipelineConfig
    from stutter_tpu_torch.infer import EnsemblePredictor
    from stutter_tpu_torch.train.seq_pipeline import (
        ARCHS, default_train_cfg, load_corpus_clips)
    from stutter_tpu_torch.train.seq_trainer import (
        prepare_sequence_dataset, standardize_sequences, train_sequence_model)
    from stutter_tpu_torch.train.trainer import total_steps

    cfg = PipelineConfig()
    out_dir = os.path.join(root, cfg.data.output_dir)
    res = {"epochs": SEQ_EPOCHS, "launches_by_entry": {}}

    # phase 8 cached the features: run_cv extracts them anew, as on a fresh
    # workspace, so the 149-dim kernels run in this entry point too
    shutil.rmtree(os.path.join(root, cfg.data.cache_dir), ignore_errors=True)
    cv, s = counted_entry(
        res["launches_by_entry"], "run_cv_seq", SEQ_KERNELS,
        lambda: pipeline.run_cv(root, cfg, include_host=False, include_seq=True,
                                seq_epochs=SEQ_EPOCHS, device=dev))
    stages = cv["stage_s"]
    with open(os.path.join(out_dir, "FINAL_PERFORMANCE_TABLE.csv")) as f:
        rows = {r["Model"]: float(r["Accuracy (%)"]) for r in csv.DictReader(f)}
    n = sum(len(te) for _, te in cv["folds"])
    n_cv = max(len(tr) for tr, _ in cv["folds"])
    res["run_cv_seq"] = {"s": s, "stage_s": stages, "rows": cv["final_rows"], "steps_per_s": {
        a: {"cv_grid": total_steps(default_train_cfg(a, SEQ_EPOCHS), n_cv) / stages[f"seq_cv_{a}"],
            "refit": total_steps(default_train_cfg(a, SEQ_EPOCHS), n) / stages[f"seq_fit_{a}"]}
        for a in QUINT}}
    # the wall at the recipe's 80 epochs: the grids' and refits' stages
    # scaled by 80 / SEQ_EPOCHS (their featurization too: an upper bound)
    grids = sum(v for k, v in stages.items() if k.startswith(("seq_cv_", "seq_fit_")))
    res["run_cv_seq"]["projected_80_epochs_s"] = s + grids * (80 / SEQ_EPOCHS - 1)
    check(all(rows[f"{a.upper()}-TPU"] >= 80 for a in QUINT) and rows["Weighted-Vote-TPU"] >= 90,
          f"run_cv --seq: CV accuracy {rows}")
    check_files(out_dir, {**RUN_CV_FILES, **SEQ_FILES}, "run_cv --seq")
    with np.load(os.path.join(out_dir, "oof_probas.npz")) as z:
        check(sorted(z) == sorted(["y", "fold_of"] + [f"proba_{a}" for a in QUINT]),
              f"oof_probas.npz keys {sorted(z)}")
    with open(os.path.join(out_dir, "ensemble.json")) as f:
        ens = json.load(f)
    check(sorted(ens["weights"]) == sorted(QUINT) and ens["classes"] == list(CLASSES),
          f"ensemble.json {ens}")
    res["vote_weights"] = ens["weights"]

    # the trained vote served: the request mix, denoised, each its class;
    # then without denoise against the CPU's plain path
    clips = [train_clip(rng, i, int(d * SR), SR) for i, d in enumerate(REQUEST_S)]
    ens_card = EnsemblePredictor.load(out_dir, device=dev)
    ens_cpu = EnsemblePredictor.load(out_dir, device="cpu")
    launch_counts(reset=True)
    answers = [ens_card.predict_clip(y) for y in clips]
    diff = 0.0
    for i, (y, r) in enumerate(zip(clips, answers)):
        check_answer(r, "trained vote")
        check(r["label"] == CLASSES[i % 3], f"trained vote: request {i} of class "
              f"{CLASSES[i % 3]} labelled {r}")
        a, b = ens_card.predict_clip(y, denoise=False), ens_cpu.predict_clip(y, denoise=False)
        diff = max(diff, proba_diff(a, b))
        check(a["label"] == b["label"] and diff < 1e-3, f"trained vote cuda vs cpu: {a} {b}")
    launches = launch_counts(reset=True)
    check_launched(launches, ["spectral_gate", "spectromel_mel"], "trained vote served")
    res["serve"] = {"launches": launches, "labels": [r["label"] for r in answers],
                    "cuda_vs_cpu_max_proba_diff": diff}
    res["launches"] = {k: sum(c[k] for c in res["launches_by_entry"].values()) for k in KERNELS}
    del ens_card, ens_cpu

    # the corpus's frames, for the fed steps, the resume, the window and memory
    seq_clips, labels = load_corpus_clips(root, cfg, device=dev)
    y = np.asarray([CLASSES.index(l) for l in labels])
    frames = {kind: prepare_sequence_dataset(seq_clips, kind, device=dev)
              for kind in ("logmel", "mfcc_deltas")}
    archs = ("cnn", "cnn_bilstm", "transformer")
    # fed steps, card vs CPU.  Five Adam steps carry FP32's rounding into
    # each update, and a zero-initialized bias is nothing but its updates,
    # so the CPU's own FP32 weights lie up to ~2e-4 normwise from the same
    # steps in FP64 on such tensors (and <1e-5 on the others): each tensor
    # is held to the larger of 1e-4 and twice that distance, both reported
    res["fed_steps"] = {}
    cpu = torch.device("cpu")
    for arch in archs:
        X, nv = frames[ARCHS[arch]["kind"]]
        tc = default_train_cfg(arch, SEQ_EPOCHS)  # mixup 0.2 on the log-mel heads
        on_card = seq_fed_steps(dev, arch, X, nv, y, tc)
        on_cpu = seq_fed_steps(cpu, arch, X, nv, y, tc)
        exact = seq_fed_steps(cpu, arch, X, nv, y, tc, dtype=torch.float64)
        errs = {k: {**step_errors(on_card[k], v),
                    "cpu_fp32_vs_fp64": step_errors(v, exact[k])["rel"]}
                for k, v in on_cpu.items()}
        over = {k: e for k, e in errs.items() if e["rel"] >= max(1e-4, 2 * e["cpu_fp32_vs_fp64"])}
        res["fed_steps"][arch] = {"max_rel": max(e["rel"] for e in errs.values()),
                                  "max_elem_rel": max(e["max_elem_rel"] for e in errs.values()),
                                  "max_cpu_fp32_vs_fp64": max(e["cpu_fp32_vs_fp64"]
                                                              for e in errs.values()),
                                  "over_bound": sorted(over), "by_tensor": errs}
        check(not over, f"{arch} fed steps card vs cpu: {over}")

    # checkpoint resume: stopped at half its steps (the later checkpoint
    # gone), resumed, against an uninterrupted run
    X, nv = frames["logmel"]
    Xs = standardize_sequences(X, nv)[0]
    tc = default_train_cfg("cnn", 2)
    half = total_steps(tc, len(y)) // 2
    args = (ARCHS["cnn"]["module"], ARCHS["cnn"]["init_fn"], Xs, nv, y, len(CLASSES), tc,
            ARCHS["cnn"]["init_kwargs"](len(CLASSES)))
    whole = train_sequence_model(*args, device=dev)
    ck = os.path.join(root, "ckpt_resume")
    train_sequence_model(*args, ckpt_dir=ck, ckpt_every=half, device=dev)
    os.remove(os.path.join(ck, f"step_{2 * half}.pt"))
    resumed = train_sequence_model(*args, ckpt_dir=ck, ckpt_every=half, device=dev)
    shutil.rmtree(ck)
    res["resume"] = {"steps": 2 * half, "resumed_at": half, "by_tensor": {
        k: step_errors(resumed[k], v) for k, v in whole.items()}}
    res["resume"]["max_rel"] = max(e["rel"] for e in res["resume"]["by_tensor"].values())
    check(res["resume"]["max_rel"] < 1e-5, f"checkpoint resume: {res['resume']}")

    # a profiled window of 20 grid steps per architecture (the CV grid's
    # shape), then the peak memory of 2 steps at G = 5 and G = 25
    window = SEQ_WINDOW
    res["profile_steps"], res["peak_memory_gb"] = {}, {}
    for arch in archs:
        X, nv = frames[ARCHS[arch]["kind"]]
        tc = default_train_cfg(arch, SEQ_EPOCHS)
        _, trainer, steps = seq_grid_parts(arch, dev, X, nv, y, 5, tc, window + 1)
        trainer.step(*steps.batch(window))

        def run(trainer=trainer, steps=steps):
            for t in range(window):
                trainer.step(*steps.batch(t))

        prof = device_profile(run, reps=1)
        res["profile_steps"][arch] = {
            **prof, "steps": window, "ms_per_step": prof["wall_ms"] / window,
            "device_ms_per_step": prof["device_ms"] / window,
            "launches_per_step": prof["launches"] / window}
        del trainer, steps
        res["peak_memory_gb"][arch] = {}
        for G in (5, 25):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _, trainer, steps = seq_grid_parts(arch, dev, X, nv, y, G, tc, 2)
            for t in range(2):
                trainer.step(*steps.batch(t))
            torch.cuda.synchronize()
            res["peak_memory_gb"][arch][f"G{G}"] = torch.cuda.max_memory_allocated() / 1e9
            del trainer, steps
    torch.cuda.empty_cache()
    return res


def mesh_wall_s(mesh, fn, reps: int = PAR_REPS) -> float:
    """The median wall seconds of `reps` runs of fn(), each synchronised on
    every device of the mesh."""
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        for d in set(mesh):
            torch.cuda.synchronize(d)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def parallel_phase(rng, dev, out_dir: str) -> dict:
    """Phase 10: every sharded path over every visible GPU and, on one GPU,
    over a split of the card into two shards, each against the same work
    unsharded (a mesh of one, or the plain entry point on one device):
    within PAR_TOL with the largest difference reported, labels and
    predictions equal, a mesh of one bitwise equal to the unsharded entry
    point.  Each sharded path's kernels are counted on its first run; its
    wall and the unsharded one's are medians of PAR_REPS runs."""
    import torch

    from stutter_tpu_torch.config import FEATURES_149, DenoiseConfig
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.infer import SeqPredictor, _ensemble_fused, _member_groups
    from stutter_tpu_torch.models.mlp import init_mlp
    from stutter_tpu_torch.ops.frontend import extract_features_149_batch, extract_features_numpy
    from stutter_tpu_torch.parallel import mesh as M
    from stutter_tpu_torch.train.seq_pipeline import cross_validate_seq, default_train_cfg
    from stutter_tpu_torch.train.splits import stratified_kfold
    from stutter_tpu_torch.train.trainer import MLPTrainConfig, cross_validate_mlp

    gpus = M.make_mesh()
    one = M.make_mesh(devices=gpus[:1])
    meshes = {"gpus": gpus}
    if len(gpus) == 1:  # the split and the gather on one card, not two devices
        meshes["split_of_one_card"] = M.make_mesh(devices=gpus * 2)
    res = {"gpus": len(gpus), "meshes": {k: [str(d) for d in m] for k, m in meshes.items()},
           "tolerance": PAR_TOL, "paths": {}, "launches_by_path": {}}

    def path(name: str, kernels, sharded, unsharded, diff, direct=None, over=meshes) -> None:
        """sharded(mesh) for each mesh `over` against unsharded(); direct(),
        where given, is the unsharded entry point a mesh of one must equal
        bitwise."""
        ref = unsharded()
        out = res["paths"][name] = {"unsharded_s": mesh_wall_s(one, unsharded)}
        if direct is not None:
            out["mesh_of_one_bitwise"] = bool(np.array_equal(sharded(one), direct()))
            check(out["mesh_of_one_bitwise"], f"{name}: a mesh of one differs from unsharded")
        for key, mesh in over.items():
            if kernels:
                got, _ = counted_entry(res["launches_by_path"], f"{name} {key}", kernels,
                                       lambda: sharded(mesh))
            else:
                got = sharded(mesh)
            err = diff(got, ref)
            check(err <= PAR_TOL, f"{name} over {key}: differs by {err} from unsharded")
            out[key] = {"max_abs_diff": err, "sharded_s": mesh_wall_s(mesh, lambda: sharded(mesh))}

    def abs_diff(a, b) -> float:
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    def same_argmax(a, b) -> float:
        check(np.array_equal(np.asarray(a).argmax(-1), np.asarray(b).argmax(-1)),
              "sharded predictions differ from unsharded")
        return abs_diff(a, b)

    # the batch front end and the gate at the corpus path's batch shapes
    audio = structured_clips(rng, 256, 49152)
    audio[:, 48000:] = 0
    lengths = np.full(256, 48000, np.int32)
    on_dev = (torch.from_numpy(audio).to(dev), torch.from_numpy(lengths).to(dev))
    path("extract_features_sharded B=256 3s", ["spectromel", "chroma_stats"],
         lambda m: M.extract_features_sharded(m, audio, lengths),
         lambda: extract_features_149_batch(*on_dev).cpu().numpy(), abs_diff,
         direct=lambda: extract_features_149_batch(*on_dev).cpu().numpy())
    gate = (audio[:64], lengths[:64])
    gate_dev = (on_dev[0][:64].contiguous(), on_dev[1][:64])
    path("denoise_sharded B=64 3s", ["spectral_gate"], lambda m: M.denoise_sharded(m, *gate),
         lambda: denoise_batch(*gate_dev).cpu().numpy(), abs_diff,
         direct=lambda: denoise_batch(*gate_dev).cpu().numpy())
    del on_dev, gate_dev

    # run_bucketed over the request mix, under extract_features_numpy
    clips = [structured_clips(rng, 1, int(d * SR))[0] for d in REQUEST_S]
    path("run_bucketed request mix", ["spectromel", "chroma_stats"],
         lambda m: extract_features_numpy(clips, FEATURES_149, device=dev, mesh=m),
         lambda: extract_features_numpy(clips, FEATURES_149, device=dev, mesh=one), abs_diff)

    # the quint's vote at its published widths, B = 8 of the request mix
    write_quint(rng, out_dir, dev)
    members = [SeqPredictor.load(out_dir, a, device=dev) for a in QUINT]
    n = max(len(c) for c in clips)
    batch = np.zeros((len(clips), -(-n // 512) * 512), np.float32)
    lens = np.asarray([len(c) for c in clips], np.int32)
    for i, c in enumerate(clips):
        batch[i, : len(c)] = c
    groups = _member_groups(members)
    b_dev, l_dev = torch.from_numpy(batch).to(dev), torch.from_numpy(lens).to(dev)

    def fused():
        return _ensemble_fused(b_dev, l_dev, lens, groups, len(members), DenoiseConfig(), True,
                               SR).cpu().numpy()

    path("ensemble_sharded quint B=8", ["spectral_gate", "spectromel_mel"],
         lambda m: M.ensemble_sharded(m, batch, lens, members), fused, same_argmax,
         direct=fused)
    del b_dev, l_dev, groups, members

    # cross_validate_mlp: 5 folds x 8 seeds (G = 40) at the published widths
    N, cfg = 600, MLPTrainConfig(epochs=20)
    y = np.arange(N) % 3
    X = (rng.randn(N, 149) + 0.5 * np.eye(3)[y] @ rng.randn(3, 149)).astype(np.float32)
    folds = stratified_kfold(y, 5, seed=42)
    path("cross_validate_mlp G=40 20 epochs", (),
         lambda m: cross_validate_mlp(X, y, folds, cfg, device=dev, mesh=m)[1],
         lambda: cross_validate_mlp(X, y, folds, cfg, device=dev, mesh=one)[1], same_argmax)

    # cross_validate_seq: the cnn at its published widths, 2 epochs, 5 folds
    # x (mesh size) seeds, a chunk of 5 entries a device
    seq_clips = [train_clip(rng, i, 3 * SR, SR) for i in range(300)]
    y_seq = np.arange(300) % 3
    seq_folds = stratified_kfold(y_seq, 5, seed=42)
    for key, mesh in meshes.items():
        def cv(m, n_seeds=len(mesh)):
            return cross_validate_seq("cnn", seq_clips, y_seq, seq_folds, 3,
                                      default_train_cfg("cnn", 2), n_seeds=n_seeds, grid_chunk=5,
                                      device=dev, mesh=m)[1]

        path(f"cross_validate_seq cnn G={5 * len(mesh)} 2 epochs ({key})", ["spectromel_mel"],
             cv, lambda: cv(one), same_argmax, over={key: mesh})

    # one data-parallel step (Adam, a 256-row batch), train_mlp_dp for 3
    # epochs, dp_eval_accuracy: the 149-256-128-64-3 MLP
    init = init_mlp(0, 149, (256, 128, 64), 3)
    rows = rng.randint(0, N, 256)

    def dp_step(m):
        step = M.make_dp_train_step(m, lambda ps: torch.optim.Adam(ps, lr=1e-3))
        params, loss = step(M.replicate(m, init), *M.shard_batch(m, X[rows], y[rows]))
        return np.concatenate([params[0][k].detach().cpu().numpy().ravel() for k in init]
                              + [[float(loss)]])

    path("make_dp_train_step Adam B=256", (), dp_step, lambda: dp_step(one), abs_diff)

    def dp_train(m):
        return M.train_mlp_dp(m, X, y, epochs=3, init=init)

    def flat(p):
        return np.concatenate([p[k].cpu().numpy().ravel() for k in init])

    path("train_mlp_dp 3 epochs", (), lambda m: flat(dp_train(m)), lambda: flat(dp_train(one)),
         abs_diff)
    trained = dp_train(one)
    path("dp_eval_accuracy", (),
         lambda m: M.dp_eval_accuracy(m, M.replicate(m, trained), X, y),
         lambda: M.dp_eval_accuracy(one, M.replicate(one, trained), X, y), abs_diff)
    for key in meshes:
        check(res["paths"]["dp_eval_accuracy"][key]["max_abs_diff"] == 0.0,
              f"dp_eval_accuracy over {key} differs")
    res["launches"] = {k: sum(c[k] for c in res["launches_by_path"].values()) for k in KERNELS}
    return res


# phase 11: block_and_time's dispatches a call; the __global__ kernels a
# trace must show, by the wrapper (launch_counts) that launches each
PROF_ITERS = 10
TRACE_ATTEMPTS = 3
TRACE_KERNELS = {"gate_analysis": "spectral_gate", "gate_iir_mask": "spectral_gate",
                 "gate_synth": "spectral_gate", "spectromel_frames": "spectromel",
                 "spectromel_stats": "spectromel", "tuning_tail": "spectromel",
                 "chroma_stats_kernel": "chroma_stats"}
TRACED = {"request_149": tuple(TRACE_KERNELS),
          "request_vote": ("gate_analysis", "gate_iir_mask", "gate_synth", "spectromel_frames")}


def trace_kernel_events(logdir: str) -> dict:
    """The one trace file under `logdir`: its size, and its kernel events
    (profile_window's burst left out) by the __global__ name each of
    TRACE_KERNELS matches."""
    import glob
    import re

    from stutter_tpu_torch.utils.profiling import BURST_KERNEL

    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    check(len(files) == 1, f"trace: expected one trace file in {logdir}, found {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events
             if e.get("cat") == "kernel" and BURST_KERNEL not in e.get("name", "")]
    return {"bytes": os.path.getsize(files[0]), "kernel_events": len(names),
            "events": {k: sum(bool(re.search(rf"\b{k}\b", n)) for n in names)
                       for k in TRACE_KERNELS}}


def check_trace(res: dict, launches: dict, kernels, what: str) -> None:
    """Each of `kernels` has a device event in the trace, and every traced
    kernel has one event per launch of its wrapper: the gate's three and
    spectromel's launch 1 for each launch of either spectromel mode, its
    stats launch for each stats-mode launch, the tail for each stats-mode
    launch and at most each mel-mode one (the sequence featurizer's runs
    without it), chroma_stats_kernel for each chroma_stats launch."""
    ev, sm, mel = res["events"], launches["spectromel"], launches["spectromel_mel"]
    want = {k: launches[w] for k, w in TRACE_KERNELS.items()}
    want["spectromel_frames"] = sm + mel
    for k in kernels:
        check(ev[k] > 0, f"{what}: no device event of {k} in the trace: {ev}")
    for k, n in want.items():
        ok = sm <= ev[k] <= sm + mel if k == "tuning_tail" else ev[k] == n
        check(ok, f"{what}: {ev[k]} events of {k} in the trace, launches {launches}")


def profiling_phase(rng, dev, out_dir: str) -> dict:
    """Phase 11: the port's timing and trace primitives (utils.profiling)
    on the main path.  block_and_time on a 3 s 149-dim request, a 3 s
    request to the vote, the 149-dim front end at B=256 x 3 s (a device
    tensor out) and the same batch over a two-shard mesh on one card (and
    on the last GPU when there are more), each no shorter than 0.9 x the
    device time device_profile reads for the same call, beside that call's
    CUDA-event median; then trace() around one request of each model, each
    kernel of the path in the trace once per launch of its wrapper."""
    import torch

    from stutter_tpu_torch.config import PipelineConfig
    from stutter_tpu_torch.infer import EnsemblePredictor, Predictor
    from stutter_tpu_torch.io import mp3
    from stutter_tpu_torch.io.native import native_available
    from stutter_tpu_torch.ops.frontend import extract_features_149_batch
    from stutter_tpu_torch.parallel.mesh import extract_features_sharded, make_mesh, shard_batch
    from stutter_tpu_torch.utils.profiling import TraceIncomplete, block_and_time, trace

    res = {"mp3_available": mp3.available(), "native_available": native_available(),
           "iters": PROF_ITERS}
    write_artifacts(rng, out_dir, dev, PipelineConfig())
    write_quint(rng, out_dir, dev)
    pred = Predictor.load(out_dir, device=dev)
    ens = EnsemblePredictor.load(out_dir, device=dev)
    pred.warmup()
    ens.warmup()
    y = structured_clips(rng, 1, 3 * SR)[0]
    audio = torch.from_numpy(structured_clips(rng, 256, 49152)).to(dev)
    audio[:, 48000:] = 0
    lengths = torch.full((256,), 48000, dtype=torch.int32, device=dev)
    n_gpus = torch.cuda.device_count()
    meshes = {"cuda:0 x2": make_mesh(devices=["cuda:0"] * 2)}
    if n_gpus > 1:
        meshes[f"cuda:{n_gpus - 1} x2"] = make_mesh(devices=[f"cuda:{n_gpus - 1}"] * 2)

    calls = {"predict_clip_149 3s": (dev, lambda: pred.predict_clip(y)),
             "predict_clip_vote 3s": (dev, lambda: ens.predict_clip(y)),
             "features_149 B=256 3s": (dev, lambda: extract_features_149_batch(audio, lengths))}
    for key, mesh in meshes.items():
        calls[f"extract_features_sharded {key}"] = (
            mesh[0], lambda m=mesh: extract_features_sharded(m, audio, lengths))
        # the shards' [128, 149] device tensors, left on their devices
        calls[f"features_149 shards {key}"] = (mesh[0], lambda m=mesh: [
            extract_features_149_batch(a, n) for a, n in zip(*shard_batch(m, audio, lengths))])
    launch_counts(reset=True)
    res["calls"] = {}
    for name, (d, fn) in calls.items():
        with torch.cuda.device(d):
            bt_ms = block_and_time(fn, iters=PROF_ITERS) * 1e3
            prof = device_profile(fn, attempts=3)
            ev_ms = time_ms(fn)
        res["calls"][name] = {"block_and_time_ms": bt_ms, "device_ms": prof["device_ms"],
                              "profiled_wall_ms": prof["wall_ms"], "cuda_event_ms": ev_ms,
                              "launches_per_call": prof["launches"],
                              "profile_windows": prof["windows"]}
        check(prof["complete"], f"{name}: every profile window lost device kernels")
        check(bt_ms >= 0.9 * prof["device_ms"],
              f"{name}: block_and_time {bt_ms:.3f} ms < 0.9 x device {prof['device_ms']:.3f} ms")

    res["traces"] = {}
    for name, fn in (("request_149", lambda: pred.predict_clip(y)),
                     ("request_vote", lambda: ens.predict_clip(y))):
        # a trace that lost device events raises TraceIncomplete: traced
        # anew into a fresh directory, TRACE_ATTEMPTS times at most
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            logdir = os.path.join(out_dir, f"trace_{name}_{attempt}")
            before = launch_counts()
            try:
                with trace(logdir, device=dev):
                    fn()
                break
            except TraceIncomplete:
                check(attempt < TRACE_ATTEMPTS, f"trace {name}: every trace lost device events")
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        t = res["traces"][name] = {**trace_kernel_events(logdir), "launches": launches,
                                   "attempts": attempt}
        check_trace(t, launches, TRACED[name], f"trace {name}")
    res["launches"] = launch_counts(reset=True)
    check_launched(res["launches"], FRONT_END_KERNELS, "profiling")
    return res


def profiling_main() -> int:
    """Phase 11 in a process of its own, the kernels phase 1 built loaded
    from the build directory: prints its result as one JSON line.  On the
    card machine torch.profiler loses the first kernels of a window, more
    as a process runs; the windows open on a burst that the loss takes
    (utils.profiling.profile_window), and the traces this phase checks
    are still taken where the loss is least, in a fresh process."""
    from stutter_tpu_torch import _build
    from stutter_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    for name in LIBRARIES:
        _build.load_library(name)
    with tempfile.TemporaryDirectory() as out_dir:
        print(json.dumps(profiling_phase(np.random.RandomState(11), dev, out_dir)))
    return 0


def kernel_names(fn) -> list:
    """The full names of the device kernels one call of `fn` launches
    (torch.profiler, profile_window's burst left out)."""
    import torch
    from torch.profiler import ProfilerActivity

    from stutter_tpu_torch.utils.profiling import BURST_KERNEL, profile_window

    fn()
    torch.cuda.synchronize()
    with profile_window([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and BURST_KERNEL not in e.name})


def attention_phase(rng, dev) -> dict:
    """Phase 12: each mode of csrc/gated_attention.cu (WavLM's gated
    attention on padded rows, models/wavlm.gated_attention; W2V-BERT 2.0's
    relative-key attention on packed rows, models/w2v_bert.relkey_attention;
    Parakeet's Transformer-XL attention at head width 128,
    models/parakeet.xl_attention) at its cells' shapes
    (kernel_phases.mode_shapes), each held to the plain version on the CPU
    and timed beside it, SDPA and the bound; each instantiation of
    csrc/glu_depthwise.cu (models/w2v_bert.glu_depthwise,
    models/parakeet.glu_conv_silu) at the same shapes' clips, held to its
    plain version on the card and timed beside it, the padded path's
    F.conv1d and the bound; then one encode call of WavLM-Large, one of
    W2V-BERT 2.0 and one of Parakeet-CTC-1.1B (drawn weights) on
    ENCODE_S's clips, each one's launches counted from just before it to
    just after it, and one conv module call's kernels of each Conformer ->
    {kernel: {"shapes", "encode"}}."""
    import torch

    from stutter_tpu_torch.config import ParakeetConfig, W2VBertConfig, WavLMConfig
    from stutter_tpu_torch.models import encoder_module
    from stutter_tpu_torch.tools.kernel_phases import (
        ATTENTION_MODES, CONV_MODES, attention_check, attention_model, attention_ops, clip_frames,
        conv1d_call, conv_bound, conv_check, conv_model, frames_of, kernel_times, mode_shapes,
        sdpa_call)

    res = {}
    for mode in ATTENTION_MODES:
        M, kernel = attention_model(mode)
        core, plain = getattr(M, kernel), getattr(M, f"{kernel}_plain")
        res[kernel] = {"tolerance": ATTN_TOL, "shapes": {}}
        for B, T in mode_shapes(mode):
            r = attention_check(B, T, dev, mode)
            p, cfg, *acts = inputs = r.pop("inputs")
            frames = frames_of(acts[-1])
            what = f"{kernel} B={B} T={T}"
            check(r["gap"] <= ATTN_TOL, f"{what}: {r['gap']:.2e} from the plain version")
            check(r["padded_rows_zero"], f"{what}: a row past a clip's frames is not zero")
            check(r["launches"] == 1, f"{what}: {r['launches']} launches a call")
            check(r["extra_bytes"] <= 1 << 20, f"{what}: {r['extra_bytes']} bytes beyond the output")
            check(r["pairs"] == r["pairs_run"] and r["counted_call_equal"],
                  f"{what}: the kernel multiplied {r['pairs']} pairs, attn_pairs_run counts "
                  f"{r['pairs_run']}, the counted call equal {r['counted_call_equal']}")
            check(r.get("pos_products") == r.get("pos_products_run"),
                  f"{what}: the kernel computed {r.get('pos_products')} positional products, "
                  f"pos_products_run counts {r.get('pos_products_run')}")
            # each activation (frames aside) read once and the output written once
            r.update(bound(4 * len(acts) * cfg.hidden_size * int(frames.sum()),
                           attention_ops(frames.tolist(), cfg)),
                     B=B, ms=time_ms(lambda: core(p, 0, *acts, cfg)),
                     plain_ms=time_ms(lambda: plain(p, 0, *acts, cfg)),
                     library_ms=time_ms(sdpa_call(*inputs)))
            res[kernel]["shapes"][f"{B}x{T}"] = r
            del inputs, p, acts, frames

    for mode in CONV_MODES:
        M, kernel = conv_model(mode)
        core, plain = getattr(M, kernel), getattr(M, f"{kernel}_plain")
        res[kernel] = {"tolerance": ATTN_TOL, "shapes": {}}
        for B, T in mode_shapes(mode):
            r = conv_check(clip_frames(B, T, B * 1000 + T), dev, mode=mode)
            x, w, clips = r.pop("inputs")
            what = f"{kernel} B={B} T={T}"
            check(r["gap"] <= ATTN_TOL, f"{what}: {r['gap']:.2e} from the plain version")
            check(r["launches"] == 1, f"{what}: {r['launches']} launches a call")
            check(r["extra_bytes"] <= 1 << 20,
                  f"{what}: {r['extra_bytes']} bytes beyond the output")
            check(not r["written_past_rows"] and r["again_equal"],
                  f"{what}: written past row R {r['written_past_rows']}, "
                  f"again equal {r['again_equal']}")
            lib = conv1d_call(x, w, clips)
            dev_ms = {k: sum(kernel_times(f).values()) for k, f in (
                ("kernel", lambda: core(x, *w, clips)),
                ("plain", lambda: plain(x, *w, clips)), ("library", lib))}
            r.update(conv_bound(r["rows"], w[0].shape[0], w[0].shape[-1], mode), B=B,
                     ms=time_ms(lambda: core(x, *w, clips)),
                     plain_ms=time_ms(lambda: plain(x, *w, clips)),
                     library_ms=time_ms(lib), device_ms=dev_ms["kernel"],
                     plain_device_ms=dev_ms["plain"], library_device_ms=dev_ms["library"])
            res[kernel]["shapes"][f"{B}x{T}"] = r
            del x, w, clips, lib

    lengths = [int(s * SR) for s in ENCODE_S]
    audio = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        audio[i, :n] = structured_clips(rng, 1, n)[0]
    a, n = torch.from_numpy(audio).to(dev), torch.tensor(lengths, device=dev)
    # (kernel, model, config, the activations each layer's core reads and
    # writes: x, q, k, v and the output; q, k, v and the output; the
    # model's kernels, each once a layer)
    # (kernel, model, config, the activations each layer's core reads and
    # writes, the model's kernels each once a layer, its conv core's kernel)
    encoders = (("gated_attention", "WavLM-Large", WavLMConfig(), 5, ("gated_attention",), None),
                ("relkey_attention", "W2V-BERT 2.0", W2VBertConfig(), 4,
                 ("relkey_attention", "glu_depthwise"), "glu_depthwise"),
                ("xl_attention", "Parakeet-CTC-1.1B", ParakeetConfig(), 4,
                 ("xl_attention", "glu_conv_silu"), "glu_conv_silu"))
    for kernel, model, cfg, tensors, kernels, conv_kernel in encoders:
        M = encoder_module(cfg)
        p = M.encoder_for(cfg).params(dev)
        M.encode(p, a, n, cfg)  # the bucket vector, cuDNN's algorithms
        torch.cuda.synchronize()
        launch_counts(reset=True)
        emb = M.encode(p, a, n, cfg)
        torch.cuda.synchronize()
        launches = launch_counts(reset=True)
        what = f"{kernel}: encode"
        check(all(launches[k] == cfg.num_hidden_layers for k in kernels),
              f"{what}: {launches}, {cfg.num_hidden_layers} layers")
        check(sum(launches.values()) == sum(launches[k] for k in kernels),
              f"{what}: other launches {launches}")
        frames = [int(M.frame_lengths(x, cfg) if kernel != "relkey_attention"
                      else M.frame_lengths(x)) for x in lengths]
        # the 0.01 s clip: no frame for WavLM and W2V-BERT, one for Parakeet
        check(bool(torch.isfinite(emb).all()) and (frames[0] > 0 or not emb[0].any()),
              f"{what}: an embedding not finite, or the clip of no frame's not zero")
        dev_ms = device_ms(lambda: M.encode(p, a, n, cfg))
        res[kernel]["encode"] = {
            "model": model, "clips": len(lengths), "frames": frames, "launches": launches,
            "ms": dev_ms.get(f"{kernel}_kernel", 0.0), "encode_device_ms": sum(dev_ms.values()),
            **bound(cfg.num_hidden_layers * 4 * tensors * cfg.hidden_size * sum(frames),
                    cfg.num_hidden_layers * attention_ops(frames, cfg))}
        if conv_kernel is not None:
            # the conv module: its kernel in place of a library's depthwise
            # conv (the stem's grouped Conv2d aside) and transposing copies
            names = kernel_names(lambda: M.encode(p, a, n, cfg))
            if conv_kernel == "glu_depthwise":
                check(not any("conv_depthwise" in k for k in names),
                      f"{what}: a depthwise conv of ATen's or cuDNN's: {names}")
            from stutter_tpu_torch.models.w2v_bert import pack_clips

            clips = pack_clips(frames, dev)
            h = torch.randn(sum(frames), cfg.hidden_size, device=dev)
            conv = kernel_names(lambda: M.conv_module(p, 0, h, clips, cfg))
            check(any(f"{conv_kernel}_kernel" in k for k in conv)
                  and not any("copy" in k or "conv_depthwise" in k or "transpose" in k
                              for k in conv), f"{what}: the conv module's kernels {conv}")
            total = sum(frames) * cfg.num_hidden_layers
            taps = getattr(cfg, "conv_depthwise_kernel_size", None) or cfg.conv_kernel_size
            res[conv_kernel]["encode"] = {
                "model": model, "clips": len(lengths), "frames": frames, "launches": launches,
                "ms": dev_ms.get(f"{conv_kernel}_kernel", 0.0), "conv_module_kernels": conv,
                **conv_bound(total, cfg.hidden_size, taps,
                             "centred" if conv_kernel == "glu_conv_silu" else "causal")}
            del h, clips
        M.release()
        del p, emb
        torch.cuda.empty_cache()
    return res


def main() -> int:
    import concurrent.futures

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from stutter_tpu_torch.config import FEATURES_334, DenoiseConfig, PipelineConfig
    from stutter_tpu_torch import _build
    from stutter_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()  # phase 1: build every kernel from the checkout, in parallel
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(_build.load_library, LIBRARIES))
    print(f"built {', '.join(_build.library_path(n).name for n in LIBRARIES)} "
          f"in {time.perf_counter() - t0:.1f} s")

    rng = np.random.RandomState(0)  # phase 2: kernel vs plain on the card
    sm, kernel_out = compare_spectromel(rng, dev, 256, 49152, 48000, timed=True)
    cs = compare_chroma_stats(*kernel_out)
    del kernel_out
    gt_small = compare_gate(rng, dev, 2, 4096, timed=False)
    gt = compare_gate(rng, dev, 64, 49152, timed=True)
    sm10, kernel_out = compare_spectromel(rng, dev, 64, 163840, 160000, timed=True)
    cs10 = compare_chroma_stats(*kernel_out)
    del kernel_out
    gt10 = compare_gate(rng, dev, 64, 163840, timed=True)
    mel = compare_spectromel_mel(rng, dev, 256, 49152)
    mel10 = compare_spectromel_mel(rng, dev, 64, 163840)
    # the request shape: one 3 s clip
    sm1, kernel_out = compare_spectromel(rng, dev, 1, 49152, 48000, timed=True)
    cs1 = compare_chroma_stats(*kernel_out)
    del kernel_out
    gt1 = compare_gate(rng, dev, 1, 49152, timed=True)
    mel1 = compare_spectromel_mel(rng, dev, 1, 49152)
    # its own generator: the later phases draw the same data as before it was added
    over = compare_tail_over_capacity(np.random.RandomState(1), dev)
    # the stream paths' shapes (their own generator too): the vote's segment
    # through the gate and the mel mode without the tail, the MLP stream's
    # windows through the stats mode and chroma_stats
    srng = np.random.RandomState(2)
    gt_seg = compare_gate(srng, dev, 1, 1 << 20, timed=True)
    mel_seg = compare_spectromel_mel(srng, dev, 1, 1 << 20, n_fft=2048, hop=512,
                                     with_tuning=False)
    sm_win, kernel_out = compare_spectromel(srng, dev, 64, 48128, 48128, timed=True)
    cs_win = compare_chroma_stats(*kernel_out)
    del kernel_out
    for name, res in (("tuning_tail over capacity 10s", over), ("spectromel 3s", sm), ("chroma_stats 3s", cs), ("spectral_gate test", gt_small),
                      ("spectral_gate 3s", gt), ("spectromel 10s", sm10),
                      ("chroma_stats 10s", cs10), ("spectral_gate 10s", gt10),
                      ("spectromel_mel 3s", mel), ("spectromel_mel 10s", mel10),
                      ("spectromel request", sm1), ("chroma_stats request", cs1),
                      ("spectral_gate request", gt1), ("spectromel_mel request", mel1),
                      ("spectral_gate stream segment", gt_seg),
                      ("spectromel_mel stream segment", mel_seg),
                      ("spectromel stream windows", sm_win),
                      ("chroma_stats stream windows", cs_win)):
        print(f"{name}: {json.dumps(res)} ({card})")
    for name, res in (("3s", sm), ("10s", sm10), ("request", sm1), ("mel 3s", mel),
                      ("mel 10s", mel10), ("mel request", mel1), ("stream windows", sm_win)):
        print(f"tuning_tail {name} B={res['B']}: {json.dumps(res['tail'])} ({card})")
    for name, res in (("3s", sm), ("stream windows", sm_win), ("request", sm1), ("10s", sm10)):
        st = res["stats_launch"]
        print(f"spectromel_stats {name} B={res['B']} N={res['N']}: {st['ms']:.4f} ms of device "
              f"time, bound {st['bound_ms']:.5f} ms ({st['bound_by']}), plan {st['plan']} ({card})")

    attn = attention_phase(np.random.RandomState(12), dev)  # phase 12, its own generator
    for kernel, res in attn.items():
        for name, r in res["shapes"].items():
            print(f"{kernel} {name}: {json.dumps(r)} ({card})")
        enc = res["encode"]
        print(f"{kernel} in one {enc['model']} encode call of {enc['clips']} clips "
              f"({sum(enc['frames'])} frames): {enc['launches'][kernel]} launches, "
              f"{enc['ms']:.4f} ms of device time, bound {enc['bound_ms']:.5f} ms "
              f"({enc['bound_by']})"
              + (f"; the call {enc['encode_device_ms']:.3f} ms" if "encode_device_ms" in enc
                 else f"; a conv module's kernels {enc['conv_module_kernels']}") + f" ({card})")

    with tempfile.TemporaryDirectory() as out_dir:  # phase 3: serving, 149-dim
        cfg149 = PipelineConfig()
        write_artifacts(rng, out_dir, dev, cfg149)
        serve = serve_requests(rng, dev, out_dir, cfg149,
                               ("spectromel", "chroma_stats", "spectral_gate"), cpu_denoise=False)
        profiles = {"request_149": profile_request(rng, dev, out_dir, cfg149)}
    print(f"serving 149: {json.dumps(serve)}")
    print(f"predict_clip p50 {serve['p50_ms']:.2f} ms over 8 requests, 149-dim ({card})")

    with tempfile.TemporaryDirectory() as root:  # phase 4: the corpus path
        corpus = corpus_phase(rng, dev, root)
    for line in corpus.pop("stage_reports"):
        print(f"  stage report: {line}")
    print(f"corpus: {json.dumps(corpus)}")
    print("corpus clips/s: " + ", ".join(f"{k} {v:.1f}" for k, v in corpus["clips_per_s"].items())
          + f" ({card})")
    check(all(v["ok"] for v in corpus["sampled_rows_vs_cpu"].values()),
          f"sampled corpus rows differ from the CPU path: {corpus['sampled_rows_vs_cpu']}")

    with tempfile.TemporaryDirectory() as out_dir:  # phase 5: serving, 286-dim
        cfg286 = PipelineConfig(features=FEATURES_334, denoise=DenoiseConfig(prop_decrease=0.8))
        write_artifacts(rng, out_dir, dev, cfg286)
        serve286 = serve_requests(rng, dev, out_dir, cfg286, ("spectromel_mel", "spectral_gate"),
                                  cpu_denoise=True)
        profiles["request_286"] = profile_request(rng, dev, out_dir, cfg286)
    print(f"serving 286: {json.dumps(serve286)}")
    print(f"predict_clip p50 {serve286['p50_ms']:.2f} ms over 8 requests, 286-dim, "
          f"prop_decrease 0.8 ({card})")

    with tempfile.TemporaryDirectory() as out_dir:  # phase 7: the headline model
        write_artifacts(rng, out_dir, dev, PipelineConfig())
        head = headline_phase(rng, dev, out_dir)
    profiles["request_ensemble"] = head.pop("profile_request")
    print(f"headline: {json.dumps(head)}")
    def mmm(s):
        return f"{s['median']:.1f} (min {s['min']:.1f}, max {s['max']:.1f}, n {s['n']})"

    print(f"ensemble predict_clip p50 {head['p50_ms']:.2f} ms over 8 requests; predict_batch "
          f"B=8 {head['batch_ms_per_clip']:.2f} ms a clip; HTTP micro-batched "
          f"{mmm(head['http']['requests_per_s'])} requests/s a burst of 8; streams over 70 s: "
          f"vote {mmm(head['stream_vote']['windows_per_s'])}, MLP "
          f"{mmm(head['stream_mlp']['windows_per_s'])} windows/s a pass ({card})")

    with tempfile.TemporaryDirectory() as root:  # phases 8 and 9: training, own generators
        train = training_phase(np.random.RandomState(6), dev, root)
        print(f"training: {json.dumps(train)}")
        seq = seq_training_phase(np.random.RandomState(7), dev, root)
    print(f"sequence training: {json.dumps(seq)}")

    cv149, cv286, prof = train["run_cv_149"], train["run_cv_286"], train["profile_steps"]
    print(f"training: run_cv {cv149['s']:.1f} s wall at 149 dims ({cv286['s']:.1f} at 286), "
          f"MLP-TPU CV {cv149['rows'][0]['Accuracy (%)']:.1f} % "
          f"({cv286['rows'][0]['Accuracy (%)']:.1f} %); CV grid G=40 "
          f"{cv149['cv_steps_per_s']:.0f} steps/s ({cv286['cv_steps_per_s']:.0f}), fit G=8 "
          f"{cv149['fit_steps_per_s']:.0f} steps/s ({cv286['fit_steps_per_s']:.0f}); a profiled "
          f"window of {prof['steps']} CV steps: {prof['ms_per_step']:.3f} ms "
          f"and {prof['launches_per_step']:.0f} launches a step, the card idle "
          f"{100 * prof['idle_share']:.1f} %; run_before_after {train['run_before_after']['s']:.1f} "
          f"s; permutation importance {cv149['stage_s']['mlp_importance']:.3f} s "
          f"({cv286['stage_s']['mlp_importance']:.3f}) ({card})")

    fed = train["fed_steps"]
    print(f"training: {len(fed['steps'])} fed steps at G=40, each against FP64 from a common "
          f"state: worst gradient {fed['worst']['grad']:.2e}, update {fed['worst']['update']:.2e}, "
          f"loss {fed['worst']['loss']:.2e} (bounds {FED_BOUNDS['grad']:.0e}, "
          f"{FED_BOUNDS['update']:.0e}, {FED_BOUNDS['loss']:.0e}); rounding-decided gates by step "
          f"{fed['flagged_by_step']}, of them flipped {fed['flipped_by_step']}; FP64's own sign "
          f"there: gradient {fed['grad_plain_max']:.2e}; each gradient held to its own norm "
          f"alone: {fed['grad_normwise']['max']:.2e} ({fed['grad_normwise']['tensor']}, "
          f"{fed['grad_normwise']['cancel']:.1e} of its scale); chained ten steps (not gated), "
          f"card vs cpu {max(e['rel'] for e in fed['chained'].values()):.2e}, card vs fp64 "
          f"{max(e['card_vs_fp64'] for e in fed['chained'].values()):.2e}, cpu vs fp64 "
          f"{max(e['cpu_vs_fp64'] for e in fed['chained'].values()):.2e}; "
          f"{train['fed_steps_s']:.1f} s ({card})")
    cvs, sp = seq["run_cv_seq"], seq["profile_steps"]
    acc = {r["Model"]: r["Accuracy (%)"] for r in cvs["rows"]}
    print(f"sequence training: run_cv --seq {cvs['s']:.1f} s wall at {SEQ_EPOCHS} epochs "
          f"(projected to 80 epochs: at most {cvs['projected_80_epochs_s']:.0f} s); "
          + "; ".join(f"{a} CV {acc[a.upper() + '-TPU']:.1f} %, grid {v['cv_grid']:.1f} "
                      f"steps/s, refit {v['refit']:.1f} steps/s"
                      for a, v in cvs["steps_per_s"].items())
          + f"; vote CV {acc['Weighted-Vote-TPU']:.1f} % ({card})")
    for arch, p in sp.items():
        print(f"sequence training: {arch} grid G=5 over {p['steps']} steps: "
              f"{p['ms_per_step']:.2f} ms, {p['device_ms_per_step']:.3f} ms of device time and "
              f"{p['launches_per_step']:.0f} launches a step, the card idle "
              f"{100 * p['idle_share']:.1f} %; peak memory G=5 "
              f"{seq['peak_memory_gb'][arch]['G5']:.2f} GB, G=25 "
              f"{seq['peak_memory_gb'][arch]['G25']:.2f} GB ({card})")
    print(f"sequence training: fed steps card vs cpu (normwise) "
          + ", ".join(f"{a} {v['max_rel']:.2e} (element {v['max_elem_rel']:.2e}; the cpu's "
                      f"fp32 vs fp64 up to {v['max_cpu_fp32_vs_fp64']:.2e})"
                      for a, v in seq["fed_steps"].items())
          + f"; checkpoint resume {seq['resume']['max_rel']:.2e}; trained vote served, "
          f"cuda vs cpu {seq['serve']['cuda_vs_cpu_max_proba_diff']:.2e} ({card})")

    with tempfile.TemporaryDirectory() as out_dir:  # phase 10: data parallelism, own generator
        par = parallel_phase(np.random.RandomState(8), dev, out_dir)
    print(f"parallel: {json.dumps(par)}")
    for name, p in par["paths"].items():
        print(f"parallel {name}: unsharded {p['unsharded_s']:.4f} s; " + "; ".join(
            f"{key} ({len(par['meshes'][key])} shards) {p[key]['sharded_s']:.4f} s, max abs diff "
            f"{p[key]['max_abs_diff']:.2e}" for key in par["meshes"] if key in p)
            + f" ({par['gpus']} GPU, {card})")

    profiles.update(profile_batches(rng, dev))  # phase 6: where the device time goes
    for name, prof in profiles.items():
        print(f"profile {name}: {json.dumps(prof)} ({card})")

    # phase 11: timing and tracing, own generator, in a process of its own
    child = subprocess.run([sys.executable, "-c",
                            "import sys, chip_smoke; sys.exit(chip_smoke.profiling_main())"],
                           cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                           text=True, timeout=600)
    check(child.returncode == 0, f"phase 11 failed: {child.stderr[-4000:]}")
    timing = json.loads(child.stdout.strip().splitlines()[-1])
    print(f"decoders on this machine: mp3.available() {timing['mp3_available']}, "
          f"native_available() {timing['native_available']}")
    print(f"timing: {json.dumps(timing)}")
    # the same call's CUDA-event medians from earlier phases, where there is one
    earlier = {"predict_clip_149 3s": f"phase 3's p50 {serve['p50_ms']:.3f} ms over the mix",
               "predict_clip_vote 3s": f"phase 7's p50 {head['p50_ms']:.3f} ms over the mix",
               "features_149 B=256 3s": f"phase 2's spectromel + chroma_stats "
                                        f"{sm['ms'] + cs['ms']:.3f} ms"}
    for name, c in timing["calls"].items():
        print(f"block_and_time {name}: {c['block_and_time_ms']:.3f} ms a call "
              f"({timing['iters']} dispatches), device {c['device_ms']:.3f} ms (profiler), "
              f"CUDA-event median {c['cuda_event_ms']:.3f} ms"
              + (f"; {earlier[name]}" if name in earlier else "") + f" ({card})")
    for name, t in timing["traces"].items():
        print(f"trace {name}: {t['bytes']} bytes, {t['kernel_events']} kernel events; "
              + ", ".join(f"{k} {n}" for k, n in t["events"].items())
              + f"; launches {json.dumps(t['launches'])} ({card})")

    # launches: each path's count, read just after it ran, summed over the paths
    paths = [serve["launches"], serve286["launches"], *corpus["launches"].values(),
             head["launches_predict_clip"], head["launches_predict_batch"],
             head["stream_vote"]["launches_one_pass"], head["stream_mlp"]["launches_one_pass"],
             head["launches_http"], train["launches"], train["serve"]["launches"],
             seq["launches"], seq["serve"]["launches"], par["launches"], timing["launches"],
             # a Conformer's one encode call holds both of its kernels' launches
             *(res["encode"]["launches"] for k, res in attn.items()
               if k not in ("glu_depthwise", "glu_conv_silu"))]
    launches = {k: sum(p[k] for p in paths) for k in KERNELS}
    # (name, max abs error, batch-shape result, request-shape result,
    # stream-shape result); no single PyTorch call computes any of these
    # functions: library_ms null
    rows = [("spectromel", sm["stats_max_err"], sm, sm1, sm_win),
            ("spectromel_mel", mel["mel_max_abs_err"], mel, mel1, mel_seg),
            ("chroma_stats", cs["max_err"], cs, cs1, cs_win),
            ("spectral_gate", gt["max_err"], gt, gt1, gt_seg)]
    kernels = [{"name": n, "route": "cuda", "source": KERNELS[n][0], "replaces": KERNELS[n][1],
                "launches": launches[n], "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None, "batch": r["B"], "request_ms": q["ms"],
                "request_plain_ms": q["plain_ms"], "request_bound_ms": q["bound_ms"],
                "stream_shape": w.get("shape", [w["B"], w.get("N")]), "stream_ms": w["ms"],
                "stream_plain_ms": w["plain_ms"], "stream_bound_ms": w["bound_ms"],
                **({"stft_library_ms": r["stft_library_ms"],
                    "request_stft_library_ms": q["stft_library_ms"]}
                   if "stft_library_ms" in r else {}),
                # spectromel's launch 3, the counterpart of the XLA
                # tuning_bin_from_candidates (stutter_tpu/ops/chroma.py:213)
                **({f"{pre}tuning_tail_{k}": t["tail"][k] for pre, t in (("", r), ("request_", q))
                    for k in ("ms", "plain_ms", "bound_ms")} if "tail" in r else {}),
                # spectromel's launch 2, the body _mfcc_stats_of
                # (stutter_tpu/ops/pallas_spectromel.py:300): profiler time
                **({f"{pre}stats_launch_{k}": t["stats_launch"][k]
                    for pre, t in (("", r), ("request_", q), ("stream_", w))
                    for k in ("ms", "bound_ms")} if "stats_launch" in r else {})}
               for n, err, r, q, w in rows]
    # each mode of the attention kernel and each conv module kernel at its
    # cell's largest batch and one request, SDPA (F.conv1d on the padded
    # batch) on the same inputs as the library's call; every shape and the
    # encode run
    def size(key):
        b, t = key.split("x")
        return int(b) * int(t)

    for kernel, res in attn.items():
        shapes = res["shapes"]
        batch = max((k for k in shapes if not k.startswith("1x")), key=size)
        request = next(k for k in shapes if k.startswith("1x"))
        ab, aq, enc = shapes[batch], shapes[request], res["encode"]
        kernels.append({"name": kernel, "route": "cuda", "source": KERNELS[kernel][0],
                        "replaces": KERNELS[kernel][1], "launches": launches[kernel],
                        "max_rel_gap": max(r["gap"] for r in res["shapes"].values()),
                        "ms": ab["ms"], "plain_ms": ab["plain_ms"], "bound_ms": ab["bound_ms"],
                        "bound_by": ab["bound_by"], "library_ms": ab["library_ms"],
                        "batch": ab["B"], "request_ms": aq["ms"],
                        "request_plain_ms": aq["plain_ms"], "request_bound_ms": aq["bound_ms"],
                        "shapes": {k: {f: r[f] for f in ("ms", "plain_ms", "library_ms",
                                                         "bound_ms", "gap", "pairs", "pairs_valid",
                                                         "device_ms", "plain_device_ms",
                                                         "library_device_ms") if f in r}
                                   for k, r in res["shapes"].items()},
                        "encode": {f: enc[f] for f in ("clips", "launches", "ms", "bound_ms")}})
    check(all(k["launches"] > 0 for k in kernels), f"a kernel never launched: {launches}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
