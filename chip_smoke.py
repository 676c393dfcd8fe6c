#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stutter_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the three
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
   clip).  A 10 s clip whose candidates overflow the tail's shared memory
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
6. Profiles one call each of the 149-dim batch front end, the batch gate
   and one 149-dim request with torch.profiler: device time per kernel,
   launches, and the device's idle share of the wall time.
7. Prints the kernels' JSON line, then {"ok": true, "device": {...}} last.

Each of the paths 3-5 runs with every launch count set to 0 just before it
and read just after, and fails if a kernel it uses never launched.

Any failed check raises, so the exit code is non-zero and no result line is
printed.  Without a CUDA GPU it exits with code 1 at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 16000
LIBRARIES = ("spectromel", "chroma_stats", "spectral_gate")  # csrc/<name>.cu
KERNELS = {  # kernel (mode) -> (source, the TPU kernel it replaces)
    "spectromel": ("stutter_tpu_torch/csrc/spectromel.cu",
                   "stutter_tpu/ops/pallas_spectromel.py:409"),
    "spectromel_mel": ("stutter_tpu_torch/csrc/spectromel.cu",
                       "stutter_tpu/ops/pallas_spectromel.py:409"),
    "chroma_stats": ("stutter_tpu_torch/csrc/chroma_stats.cu",
                     "stutter_tpu/ops/pallas_chroma.py:95"),
    "spectral_gate": ("stutter_tpu_torch/csrc/spectral_gate.cu",
                      "stutter_tpu/ops/pallas_denoise.py:265"),
}
N_CORPUS, CLASSES = 905, ("block", "fluent", "repetition")
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def launch_counts(reset: bool = False) -> dict:
    """Every wrapper's kernel launches so far, by kernel (mode); reset=True
    then sets them to 0."""
    from stutter_tpu_torch.ops.chroma_stats import chroma_stats
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate
    from stutter_tpu_torch.ops.spectromel import spectromel

    counters = {"spectromel": (spectromel, "launches"),
                "spectromel_mel": (spectromel, "mel_launches"),
                "chroma_stats": (chroma_stats, "launches"),
                "spectral_gate": (spectral_gate, "launches")}
    counts = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    if reset:
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
    return counts


def check_launched(counts: dict, kernels, path: str) -> None:
    check(all(counts[k] > 0 for k in kernels), f"{path}: a kernel never launched: {counts}")


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
    if timed:
        res["ms"] = time_ms(lambda: spectromel(audio, lengths))
        res["plain_ms"] = time_ms(lambda: spectromel_plain(audio, lengths))
        res["device_ms"] = device_ms(lambda: spectromel(audio, lengths))
        res["tail"] = {"ms": res["device_ms"]["tuning_tail"], **tail_numbers(p, 2048)}
        framed = frame(audio, 2048, 512) * hann(2048, dev)
        res["stft_library_ms"] = stft_library_ms(framed)
        del framed
    return res, (p, tb, lengths)


def compare_spectromel_mel(rng, dev, B: int, N: int) -> dict:
    """The mel-output mode at the 286-dim variant's geometry (n_fft 512, hop
    256): clip lengths from N / 4 to N, the last clip silent (one clip of
    N - 1000 samples at B=1)."""
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
    kw = dict(n_fft=512, hop_length=256, with_stats=False)
    p, m, tb = spectromel(audio, lengths, **kw)
    pp, mp, tbp = spectromel_plain(audio, lengths, **kw)
    torch.cuda.synchronize()
    res = {"B": B, "N": N, "power_rel_err": float((p - pp).abs().max() / pp.abs().max()),
           "mel_rel_err": float((m - mp).abs().max() / mp.abs().max()),
           "mel_max_abs_err": float((m - mp).abs().max()),
           "tb_equal_to_own_power": bool(torch.equal(tb, estimate_tuning_bin(p, SR, 512))),
           "tb_agree_with_plain": int((tb == tbp).sum()), "tb_last": int(tb[-1])}
    check(torch.isfinite(m).all().item(), "spectromel mel not finite")
    check(res["power_rel_err"] < 1e-5, f"spectromel mel mode power rel err {res}")
    check(res["mel_rel_err"] < 1e-4, f"spectromel mel mode mel rel err {res}")
    check(res["tb_equal_to_own_power"] and (B == 1 or res["tb_last"] == 50),
          f"spectromel mel mode tuning bin != plain estimate on its power: {res}")
    T, K = p.shape[1:]
    # power, mel and tuning bin out; FFT, |.|^2 and the sparse mel
    res.update(bound(4 * (B * N + B + B * T * K + B * T * 128 + B),
                     fft_flops(B * T, 512) + B * T * (3 * K + 2 * mel_nonzeros(512))))
    res["ms"] = time_ms(lambda: spectromel(audio, lengths, **kw))
    res["plain_ms"] = time_ms(lambda: spectromel_plain(audio, lengths, **kw))
    res["device_ms"] = device_ms(lambda: spectromel(audio, lengths, **kw))
    res["tail"] = {"ms": res["device_ms"]["tuning_tail"], **tail_numbers(p, 512)}
    framed = frame(audio, 512, 256) * hann(512, dev)
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
    return {"B": B, "max_err": err, "cluster": cluster_size(B, T),
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


def device_profile(fn, reps: int = 3) -> dict:
    """torch.profiler over `reps` calls of `fn` after a warm one: wall ms
    per call (under the profiler), device ms per call (the kernels' and
    copies' durations), the device's idle share of the wall time, launches
    per call, and the eight kernels with the most device time."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
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
            "top": [[k, v[0], v[1] / reps] for k, v in top]}


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


def write_corpus(rng, root: str) -> int:
    """N_CORPUS clips of 0.5-10 s under three class folders, unique stems
    (the feature cache is keyed by stem), ~5 % at 22.05 kHz; -> seconds of
    audio written."""
    from stutter_tpu_torch.io.wav import write_wav

    total = 0.0
    for i in range(N_CORPUS):
        d = os.path.join(root, "segrigated_samples", CLASSES[i % 3])
        os.makedirs(d, exist_ok=True)
        sr = 22050 if rng.rand() < 0.05 else SR
        dur = rng.uniform(0.5, 10.0)
        write_wav(os.path.join(d, f"clip_{i:04d}.wav"), corpus_clip(rng, int(dur * sr), sr), sr)
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
    seconds = write_corpus(rng, root)
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
    for name, res in (("tuning_tail over capacity 10s", over), ("spectromel 3s", sm), ("chroma_stats 3s", cs), ("spectral_gate test", gt_small),
                      ("spectral_gate 3s", gt), ("spectromel 10s", sm10),
                      ("chroma_stats 10s", cs10), ("spectral_gate 10s", gt10),
                      ("spectromel_mel 3s", mel), ("spectromel_mel 10s", mel10),
                      ("spectromel request", sm1), ("chroma_stats request", cs1),
                      ("spectral_gate request", gt1), ("spectromel_mel request", mel1)):
        print(f"{name}: {json.dumps(res)} ({card})")
    for name, res in (("3s", sm), ("10s", sm10), ("request", sm1), ("mel 3s", mel),
                      ("mel 10s", mel10), ("mel request", mel1)):
        print(f"tuning_tail {name} B={res['B']}: {json.dumps(res['tail'])} ({card})")

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

    profiles.update(profile_batches(rng, dev))  # phase 6: where the device time goes
    for name, prof in profiles.items():
        print(f"profile {name}: {json.dumps(prof)} ({card})")

    # launches: each path's count, read just after it ran, summed over the paths
    paths = [serve["launches"], serve286["launches"], *corpus["launches"].values()]
    launches = {k: sum(p[k] for p in paths) for k in KERNELS}
    # (name, max abs error, batch-shape result, request-shape result); no
    # single PyTorch call computes any of these functions: library_ms null
    rows = [("spectromel", sm["stats_max_err"], sm, sm1),
            ("spectromel_mel", mel["mel_max_abs_err"], mel, mel1),
            ("chroma_stats", cs["max_err"], cs, cs1), ("spectral_gate", gt["max_err"], gt, gt1)]
    kernels = [{"name": n, "route": "cuda", "source": KERNELS[n][0], "replaces": KERNELS[n][1],
                "launches": launches[n], "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None, "batch": r["B"], "request_ms": q["ms"],
                "request_plain_ms": q["plain_ms"], "request_bound_ms": q["bound_ms"],
                **({"stft_library_ms": r["stft_library_ms"],
                    "request_stft_library_ms": q["stft_library_ms"]}
                   if "stft_library_ms" in r else {}),
                # spectromel's launch 3, the counterpart of the XLA
                # tuning_bin_from_candidates (stutter_tpu/ops/chroma.py:213)
                **({f"{pre}tuning_tail_{k}": t["tail"][k] for pre, t in (("", r), ("request_", q))
                    for k in ("ms", "plain_ms", "bound_ms")} if "tail" in r else {})}
               for n, err, r, q in rows]
    check(all(k["launches"] > 0 for k in kernels), f"a kernel never launched: {launches}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
