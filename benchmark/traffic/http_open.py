"""Kind `http_open`: the port's HTTP service under open-loop Poisson load.

Set-up makes the configuration's weights on the device from the seed (one
generator, one draw for all of them), writes them through the port's
persist functions to a run-private directory under TMPDIR, starts
`stutter_tpu_torch.serve.serve` in this process (its warm-up runs every
clip bucket and every micro-batch size), sends one warm-up upload per
bucket over HTTP, and starts the load generator (loadgen.py) in a process
of its own, which warms the service with bursts of every micro-batch size
and `warm_s` seconds of the mix before it reports ready.  The window: the generator sends request i at its due time
whatever the server does; a request's latency runs from its due time to
the moment its whole response was read.  A request that fails counts as
missing.

The check: a sample of answered requests drawn from the seed, the longest
among them, run through the plain reference from their upload bytes; the
widest gap of any member's probability and of the vote's.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import gen  # noqa: E402
import stats  # noqa: E402
import tracing  # noqa: E402
from reference import dsp  # noqa: E402
from reference.config import denoise_config  # noqa: E402
from reference.quint import Quint  # noqa: E402


# ------------------------------------------------------------------ weights

def leaf_specs(config: dict) -> list[tuple[str, str, tuple, float, float]]:
    """(file, leaf, shape, mean, scale) of every weight of the service: the
    members' leaves in the JAX package's names and shapes, their scales
    those of the port's own initializers at the published widths (a leaf
    that starts constant, a bias or a gain, keeps its constant), and the
    service's feature MLP at its init scales."""
    from stutter_tpu_torch.train.seq_pipeline import ARCHS

    specs = []
    n_classes = len(config["classes"])
    for name, m in config["members"].items():
        widths = {k: (tuple(v) if isinstance(v, list) else v) for k, v in m["widths"].items()}
        tmpl = ARCHS[name]["init_fn"](np.random.RandomState(0), **widths, n_classes=n_classes)
        for leaf, v in tmpl.items():
            specs.append((name, leaf, v.shape, float(v.mean()) if v.std() == 0 else 0.0,
                          float(v.std())))
    dims = config["mlp"]["dims"]
    s = config["mlp"]["n_seeds"]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs.append(("mlp", f"w{i}", (s, a, b), 0.0, math.sqrt(2.0 / a)))
        specs.append(("mlp", f"b{i}", (s, b), 0.0, 0.05))
    return specs


def make_weights(config: dict, seed: int, device) -> dict:
    """{file: {leaf: numpy array}} drawn on `device` in one call of one
    generator seeded with `seed`, then scaled leaf by leaf."""
    specs = leaf_specs(config)
    sizes = [int(np.prod(shape)) for _, _, shape, _, _ in specs]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out: dict = {}
    for (file, leaf, shape, mean, scale), part in zip(specs, torch.split(flat, sizes)):
        out.setdefault(file, {})[leaf] = part.reshape(shape).mul_(scale).add_(mean)
    return {f: {k: v.cpu().numpy() for k, v in leaves.items()} for f, leaves in out.items()}


def norm_stats(config: dict, seed: int, device) -> dict:
    """Each feature kind's per-dimension mean and std over the valid frames
    of `norm_clips` recording-like clips (the reference's frames), as the
    port's write_quint takes them from 16 clips."""
    n, dur = config["norm_clips"], config["norm_clip_s"]
    sr = config["sample_rate"]
    kinds = {m["kind"] for m in config["members"].values()}
    sums: dict = {}
    with torch.no_grad():
        for i in range(n):
            y = gen.recording_clip(seed, 10**6 + i, int(dur * sr), sr)
            audio, length = dsp.padded(y, device)
            frames, nv = dsp.seq_frames(audio, length, kinds, sr)
            for k, f in frames.items():
                x = f[0, : int(nv[0])].double().cpu().numpy()
                sums.setdefault(k, []).append(x)
    out = {}
    for k, xs in sums.items():
        x = np.concatenate(xs)
        out[k] = (x.mean(0).astype(np.float32),
                  np.sqrt(np.maximum(x.var(0), 1e-12)).astype(np.float32))
    return out


def write_artifacts(config: dict, out_dir: str, seed: int, device) -> None:
    """The service's files, written through the port's persist functions."""
    from stutter_tpu_torch import persist
    from stutter_tpu_torch.models.mlp import SeedMLP
    from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler
    from stutter_tpu_torch.train.seq_pipeline import persist_seq_head

    w = make_weights(config, seed, device)
    norms = norm_stats(config, seed, device)
    classes = list(config["classes"])
    for name, m in config["members"].items():
        persist_seq_head(out_dir, name, w[name], *norms[m["kind"]], classes)
    with open(os.path.join(out_dir, "ensemble.json"), "w") as f:
        json.dump({"weights": {n: m["weight"] for n, m in config["members"].items()},
                   "classes": classes}, f)
    d = config["mlp"]["dims"][0]
    persist.save_mlp(os.path.join(out_dir, "model_mlp_tpu"),
                     SeedMLP.from_jax_params(w["mlp"], device=device))
    persist.save_scaler(os.path.join(out_dir, "scaler_after.npz"),
                        StandardScaler(mean_=np.zeros(d, np.float32),
                                       scale_=np.ones(d, np.float32)))
    persist.save_label_encoder(os.path.join(out_dir, "label_encoder.json"),
                               LabelEncoder(classes_=classes))


def pipeline_config(config: dict):
    from stutter_tpu_torch.config import DenoiseConfig, PipelineConfig

    return PipelineConfig(denoise=DenoiseConfig(**config["denoise"]))


# -------------------------------------------------------------------- kind

class State:
    pass


def _post(base: str, path: str, body: bytes) -> dict:
    req = urllib.request.Request(base + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def setup(ctx) -> State:
    import stutter_tpu_torch.serve as serve_mod
    from stutter_tpu_torch.infer import EnsemblePredictor

    p, cfg = ctx.params, ctx.config
    st = State()
    st.out_dir = tempfile.mkdtemp(prefix="bench_serve_")
    job = {"host": "127.0.0.1", "port": None, "seed": ctx.seed, "lengths": p["lengths"],
           "rate": p["rate"], "seconds": ctx.seconds, "upload_sr": p["upload_sr"],
           "peak": p["peak"], "wait_s": p["wait_s"], "path": p["path"], "warm_s": p["warm_s"],
           "batch_max": p["batch_max"]}
    write_artifacts(cfg, st.out_dir, ctx.seed, ctx.device)

    st.dispatches = []  # (start, end, clip lengths) of every predict_batch call
    st.calls = []  # traced runs: (start, predictor, clips) of every call
    st.uploads = {}  # traced runs: id(decoded clip) -> its upload's bytes
    st.orig = EnsemblePredictor.predict_batch
    st.orig_decode = serve_mod._decode_audio_bytes

    def counted(self, clips, *a, **k):
        t0 = time.perf_counter()
        out = st.orig(self, clips, *a, **k)
        st.dispatches.append((t0, time.perf_counter(), [len(c) for c in clips]))
        if ctx.trace:
            st.calls.append((t0, self, list(clips)))
        return out

    def decode(data, *a, **k):
        y = st.orig_decode(data, *a, **k)
        st.uploads[id(y)] = data
        return y

    EnsemblePredictor.predict_batch = counted
    if ctx.trace:
        serve_mod._decode_audio_bytes = decode
    st.httpd = serve_mod.serve(st.out_dir, cfg=pipeline_config(cfg), port=0, ensemble=True,
                               batch_window_ms=p["batch_window_ms"], batch_max=p["batch_max"],
                               device=ctx.device)
    st.thread = threading.Thread(target=st.httpd.serve_forever, daemon=True)
    st.thread.start()
    job["port"] = st.httpd.server_port
    base = f"http://127.0.0.1:{job['port']}"
    for i, n in enumerate(dsp.BUCKETS):  # the handler's decode, once a bucket
        _post(base, p["path"], gen.upload(ctx.seed, 10**7 + i, 0.9 * n / cfg["sample_rate"],
                                           p["upload_sr"], p["peak"]))
    st.loadgen = subprocess.Popen(
        [sys.executable, str(BENCH / "loadgen.py"), json.dumps(job)], cwd=str(BENCH),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    line = st.loadgen.stdout.readline().strip()
    if line != "ready":
        st.loadgen.kill()
        st.loadgen.wait()
        raise RuntimeError(f"load generator did not start: {line!r}")
    st.dispatches.clear()
    st.calls.clear()
    return st


def window(ctx, st: State) -> dict:
    p = ctx.params
    start = time.monotonic() + 0.05
    st.loadgen.stdin.write(f"{start!r}\n")
    st.loadgen.stdin.flush()
    out, _ = st.loadgen.communicate(timeout=ctx.seconds + p["wait_s"] + 60)
    if st.loadgen.returncode != 0:
        raise RuntimeError(f"load generator exited with {st.loadgen.returncode}")
    res = json.loads(out)
    st.durations = res["durations_s"]
    st.requests = res["requests"]
    lat, failed = [], 0
    for r in st.requests:
        ok = r is not None and r["status"] == 200
        failed += not ok
        lat.append((r["done"] - r["due"]) * 1e3 if ok else math.inf)
    late = [r["sent"] - r["due"] for r in st.requests if r is not None]
    trace = replay_traced(ctx, st, start) if ctx.trace else None
    done_in = sum(1 for r in st.requests if r is not None and r["done"] <= ctx.seconds)
    q = len(lat) // 4 or 1
    by_s: dict = {}
    for r, v in zip(st.requests, lat):
        if r is not None:
            by_s.setdefault(int(r["due"]), []).append(v)
    detail = {
        "offered_per_s": len(lat) / ctx.seconds,
        "completed_in_window_per_s": done_in / ctx.seconds,
        "p50_ms_first_quarter": stats.percentile(lat[:q], 50),
        "p50_ms_last_quarter": stats.percentile(lat[-q:], 50),
        "generator_late_ms": {"p50": stats.percentile(late, 50) * 1e3,
                              "p99": stats.percentile(late, 99) * 1e3,
                              "max": max(late) * 1e3},
        "p50_ms_by_second": [round(stats.percentile(by_s[k], 50), 1) for k in sorted(by_s)],
        "dispatches": len(st.dispatches),
        "longest_dispatches_ms": sorted(((d[1] - d[0]) * 1e3 for d in st.dispatches))[-5:],
        "clips_per_dispatch": (sum(len(d[2]) for d in st.dispatches)
                               / max(len(st.dispatches), 1)),
    }
    return {"metrics": {"request_p50_ms": stats.percentile(lat, 50),
                        "request_p95_ms": stats.percentile(lat, 95)},
            "attempted": len(lat), "failed": failed, "trace": trace, "detail": detail}


def replay_traced(ctx, st: State, start: float):
    """The traced window of the serve cell: the dispatches that started in
    the window's last `trace_s` seconds, replayed after it on this thread
    under the profiler, each upload decoded (and resampled) again as its
    handler did, then the dispatch's clips through the same predictor in
    the same groups.  torch.profiler stalls the threads a server starts
    while it records (the stdlib server starts one a request), so the live
    server cannot be traced; the replay has no concurrency between
    handlers and the dispatch.  The host-clock statistics come from every
    dispatch of the live window."""
    import stutter_tpu_torch.serve as serve_mod

    p = ctx.params
    t_start = time.perf_counter() - (time.monotonic() - start)
    tail = [c for c in st.calls if c[0] - t_start >= ctx.seconds - p["trace_s"]] or st.calls[-1:]
    sr = ctx.config["sample_rate"]
    with tracing.profile_window() as prof:
        with tracing.span(tracing.REGION):
            for _, pred, clips in tail:
                ys = [st.orig_decode(st.uploads[id(y)], sr, pred.device) for y in clips]
                with tracing.span("bench.dispatch"):
                    st.orig(pred, ys, sr=sr, denoise=True)
    serve_mod._decode_audio_bytes = st.orig_decode
    live = [d for d in st.dispatches if d[0] >= t_start]
    return tracing.Trace.read(prof, ctx.chips, {
        "clips_started": sum(len(c[2]) for c in tail),
        "dispatch_clips": [len(d[2]) for d in live],
        "dispatch_s": [d[1] - d[0] for d in live],
        "dispatch_lengths": [d[2] for d in live]})


def release(ctx, st: State) -> None:
    from stutter_tpu_torch.infer import EnsemblePredictor

    st.httpd.shutdown()
    st.httpd.server_close()
    st.thread.join(timeout=60)
    EnsemblePredictor.predict_batch = st.orig
    del st.httpd, st.calls, st.uploads


def _reference(ctx, st: State):
    cfg = ctx.config
    return Quint(st.out_dir, {n: m["weight"] for n, m in cfg["members"].items()},
                 {n: m["arch"] for n, m in cfg["members"].items()}, cfg["classes"],
                 denoise_config(cfg["denoise"]), cfg["sample_rate"], ctx.device)


def sampled(ctx, n: int, durations: list, answered) -> list[int]:
    longest = max(answered, key=lambda i: durations[i])
    idx = gen.sample(n, ctx.params["check_requests"], ctx.seed, always=[longest])
    return [i for i in idx if i in set(answered)]


def gaps(ref_out: dict, served: dict, classes: list) -> tuple[float, float]:
    """(widest gap of a member's probability, widest gap of the vote's)."""
    member = max(abs(served["members"][n][c] - float(ref_out["members"][n][j]))
                 for n in ref_out["members"] for j, c in enumerate(classes))
    vote = max(abs(served["proba"][c] - float(ref_out["proba"][j]))
               for j, c in enumerate(classes))
    return member, vote


def compare(ctx, st: State) -> list[dict]:
    """The sampled answers against the reference, once the program is freed."""
    p, cfg = ctx.params, ctx.config
    answered = [i for i, r in enumerate(st.requests) if r is not None and r["status"] == 200]
    out = []
    try:
        if not answered:
            return [{"name": "answered", "value": 0, "limit": len(st.requests), "ok": False}]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = _reference(ctx, st)
        member, vote = 0.0, 0.0
        for i in sampled(ctx, len(st.requests), st.durations, answered):
            body = gen.upload(ctx.seed, i, st.durations[i], p["upload_sr"], p["peak"])
            served = json.loads(st.requests[i]["body"])
            m, v = gaps(ref.predict_upload(body), served, cfg["classes"])
            member, vote = max(member, m), max(vote, v)
        lim = p["limits"]
        out = [{"name": "member_gap", "value": member, "limit": lim["member_gap"],
                "ok": member <= lim["member_gap"]},
               {"name": "vote_gap", "value": vote, "limit": lim["vote_gap"],
                "ok": vote <= lim["vote_gap"]}]
    finally:
        shutil.rmtree(st.out_dir, ignore_errors=True)
    return out


def control(ctx, seeds: list[int], n_requests: int) -> list[dict]:
    """The control at the cell's size: on each seed, the reference in TF32
    (the precision below the configuration's FP32 with TF32 off) in the
    program's place, judged as the program is, on `n_requests` sampled
    requests of the seed's mix -> per seed the two gaps."""
    p, cfg = ctx.params, ctx.config
    rows = []
    for seed in seeds:
        out_dir = tempfile.mkdtemp(prefix="bench_control_")
        try:
            write_artifacts(cfg, out_dir, seed, ctx.device)
            st = State()
            st.out_dir = out_dir
            due = gen.arrivals_s(p["rate"], ctx.seconds, p["lengths"]["shape_seed"])
            durs = gen.lengths_s(len(due), p["lengths"])
            ref = _reference(ctx, st)
            idx = gen.sample(len(durs), n_requests, seed, always=[int(np.argmax(durs))])
            member = vote = 0.0
            for i in idx:
                body = gen.upload(seed, i, float(durs[i]), p["upload_sr"], p["peak"])
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                exact = ref.predict_upload(body)
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                low = ref.predict_upload(body)
                served = {"members": {n: dict(zip(cfg["classes"], map(float, v)))
                                      for n, v in low["members"].items()},
                          "proba": dict(zip(cfg["classes"], map(float, low["proba"])))}
                m, v = gaps(exact, served, cfg["classes"])
                member, vote = max(member, m), max(vote, v)
            rows.append({"seed": seed, "member_gap": member, "vote_gap": vote})
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            shutil.rmtree(out_dir, ignore_errors=True)
    return rows
