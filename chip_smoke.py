#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stutter_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the three
   CUDA kernels from csrc/ with nvcc.
2. Holds each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at the 10 s bucket, and times both (median of
   CUDA-event timings).
3. Writes full-width artifacts from a numpy seed (149-256-128-64-3 MLP with
   8 seeds, a scaler, 3 classes), loads them with Predictor.load(device=
   "cuda"), answers 8 predict_clip requests with denoise on and one
   predict_file on a 22.05 kHz WAV, and checks that every kernel launched
   in that run.
4. Prints the kernels' JSON line, then {"ok": true, "device": {...}} last.

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
KERNELS = {
    "spectromel": ("stutter_tpu_torch/csrc/spectromel.cu",
                   "stutter_tpu/ops/pallas_spectromel.py:409"),
    "chroma_stats": ("stutter_tpu_torch/csrc/chroma_stats.cu",
                     "stutter_tpu/ops/pallas_chroma.py:95"),
    "spectral_gate": ("stutter_tpu_torch/csrc/spectral_gate.cu",
                      "stutter_tpu/ops/pallas_denoise.py:265"),
}


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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compare_spectromel(rng, dev, B: int, N: int, length: int, timed: bool):
    """-> (results, (power, tuning bin, lengths) of the kernel for chroma_stats)."""
    import torch

    from stutter_tpu_torch.ops.chroma import estimate_tuning_bin
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
    if timed:
        res["ms"] = time_ms(lambda: spectromel(audio, lengths))
        res["plain_ms"] = time_ms(lambda: spectromel_plain(audio, lengths))
    return res, (p, tb, lengths)


def compare_chroma_stats(p, tb, lengths) -> dict:
    import torch

    from stutter_tpu_torch.ops.chroma_stats import chroma_stats, chroma_stats_plain

    n_valid = 1 + torch.div(lengths, 512, rounding_mode="floor")
    got = chroma_stats(p, tb, n_valid)
    ref = chroma_stats_plain(p, tb, n_valid)
    err = float((got - ref).abs().max())
    check(err < 1e-5, f"chroma_stats err {err}")
    return {"B": p.shape[0], "max_err": err,
            "ms": time_ms(lambda: chroma_stats(p, tb, n_valid)),
            "plain_ms": time_ms(lambda: chroma_stats_plain(p, tb, n_valid))}


def compare_gate(rng, dev, B: int, N: int, timed: bool) -> dict:
    import torch

    from stutter_tpu.config import DenoiseConfig
    from stutter_tpu_torch.denoise import denoise_batch
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
    if timed:
        res["ms"] = time_ms(lambda: denoise_batch(audio, lengths, cfg))
        res["plain_ms"] = time_ms(lambda: denoise_batch(audio, lengths, cfg,
                                                        gate=spectral_gate_plain))
    return res


def write_artifacts(rng, out_dir: str, dev) -> None:
    """Full-width artifacts in the JAX package's files, via the port."""
    from stutter_tpu.config import PipelineConfig
    from stutter_tpu_torch import persist
    from stutter_tpu_torch.models.mlp import SeedMLP
    from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler
    from stutter_tpu_torch.ops.frontend import extract_features_numpy

    dims, n_seeds = (149, 256, 128, 64, 3), 8
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = (rng.randn(n_seeds, a, b) * np.sqrt(2.0 / a)).astype(np.float32)
        params[f"b{i}"] = (rng.randn(n_seeds, b) * 0.05).astype(np.float32)
    clips = list(structured_clips(rng, 16, 3 * SR))
    feats = extract_features_numpy(clips, PipelineConfig().features, device=dev)
    persist.save_mlp(os.path.join(out_dir, "model_mlp_tpu"), SeedMLP.from_jax_params(params))
    persist.save_scaler(os.path.join(out_dir, "scaler_after.npz"), StandardScaler.fit(feats))
    persist.save_label_encoder(os.path.join(out_dir, "label_encoder.json"),
                               LabelEncoder(classes_=["block", "fluent", "repetition"]))


def serve_requests(rng, out_dir: str) -> dict:
    import torch

    from stutter_tpu.io.wav import write_wav
    from stutter_tpu_torch.infer import Predictor
    from stutter_tpu_torch.ops.chroma_stats import chroma_stats
    from stutter_tpu_torch.ops.spectral_gate import spectral_gate
    from stutter_tpu_torch.ops.spectromel import spectromel

    pred = Predictor.load(out_dir, device="cuda")
    pred.warmup()
    durations = (1.5, 3, 3, 3, 3, 5, 6, 10)
    clips = [structured_clips(rng, 1, int(d * SR))[0] for d in durations]
    wav = os.path.join(out_dir, "request_22k.wav")
    write_wav(wav, structured_clips(rng, 1, int(2.5 * 22050))[0] * 0.5, 22050)

    wrappers = (spectromel, chroma_stats, spectral_gate)
    for w in wrappers:
        w.launches = 0
    latencies, results = [], []
    for y in clips:
        t0 = time.perf_counter()
        results.append(pred.predict_clip(y))
        latencies.append((time.perf_counter() - t0) * 1e3)
    results.append(pred.predict_file(wav))
    launches = {w.__name__: w.launches for w in wrappers}

    for r in results:
        p = np.array(list(r["proba"].values()))
        check(len(p) == 3 and np.isfinite(p).all() and abs(p.sum() - 1) < 1e-5,
              f"bad probabilities {r}")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")

    # the same clip through the plain versions on the CPU gives the same answer
    cpu = Predictor.load(out_dir, device="cpu")
    for y in clips[1:2]:
        a, b = pred.predict_clip(y, denoise=False), cpu.predict_clip(y, denoise=False)
        diff = max(abs(a["proba"][c] - b["proba"][c]) for c in a["proba"])
        check(a["label"] == b["label"] and diff < 1e-3, f"cuda vs cpu predict: {a} {b}")
    torch.cuda.synchronize()
    return {"launches": launches, "p50_ms": statistics.median(latencies),
            "latencies_ms": latencies, "labels": [r["label"] for r in results],
            "cuda_vs_cpu_max_proba_diff": diff}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from stutter_tpu_torch import _build
    from stutter_tpu_torch.infer import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    for name in KERNELS:  # phase 1: build every kernel from the checkout
        t0 = time.perf_counter()
        _build.load_library(name)
        print(f"built {name} in {time.perf_counter() - t0:.1f} s -> "
              f"{_build.library_path(name).name}")

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
    for name, res in (("spectromel 3s", sm), ("chroma_stats 3s", cs), ("spectral_gate test", gt_small),
                      ("spectral_gate 3s", gt), ("spectromel 10s", sm10),
                      ("chroma_stats 10s", cs10), ("spectral_gate 10s", gt10)):
        print(f"{name}: {json.dumps(res)}")

    with tempfile.TemporaryDirectory() as out_dir:  # phase 3: the serving path
        write_artifacts(rng, out_dir, dev)
        serve = serve_requests(rng, out_dir)
    print(f"serving: {json.dumps(serve)}")
    print(f"predict_clip p50 {serve['p50_ms']:.2f} ms over 8 requests ({card})")

    rows = [("spectromel", sm["stats_max_err"], sm), ("chroma_stats", cs["max_err"], cs),
            ("spectral_gate", gt["max_err"], gt)]
    kernels = [{"name": n, "route": "cuda", "source": KERNELS[n][0], "replaces": KERNELS[n][1],
                "launches": serve["launches"][n], "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"]} for n, err, r in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
