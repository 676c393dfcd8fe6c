"""Kind `corpus_pass`: passes over a corpus held in memory, as a batch user
builds a feature cache -- the device half of the port's `preprocess` plus
`extract_corpus`.

A pass: `denoise.denoise_clips` over every clip (batches of
`denoise_batch`), then `ops.frontend.extract_features_numpy` over the raw
clips and over the clean ones (batches of `features_batch`), each with
device "cuda", so the mesh is every visible GPU, as a user gets it.
Set-up makes the clips from the seed and runs one pass, which builds the
kernels and warms every shape the passes use.  The window runs whole
passes until --seconds have gone by; a clip counts when its clean audio
and both its feature rows are on the host.

The check: a sample of clips drawn from the seed, the longest among them,
through the plain reference (gate, then the 149 features of the raw and
of the reference's own clean clip), against the last pass's outputs.
"""

from __future__ import annotations

import sys
import time
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

MFCC, CHROMA = slice(0, 120), slice(120, 144)  # the 149-dim layout's blocks


class State:
    pass


def pipeline_config(config: dict):
    from stutter_tpu_torch.config import (DenoiseConfig, FeatureConfig, FrontendConfig,
                                          PipelineConfig)

    return PipelineConfig(features=FeatureConfig(frontend=FrontendConfig(**config["frontend"])),
                          denoise=DenoiseConfig(**config["denoise"]))


def make_clips(ctx) -> list[np.ndarray]:
    p, sr = ctx.params, ctx.config["frontend"]["sample_rate"]
    durs = gen.lengths_s(p["clips"], p["lengths"])
    return [gen.recording_clip(ctx.seed, i, int(d * sr), sr) for i, d in enumerate(durs)]


def one_pass(st: State, device: str) -> tuple:
    from stutter_tpu_torch.denoise import denoise_clips
    from stutter_tpu_torch.ops.frontend import extract_features_numpy

    clean = denoise_clips(st.clips, st.cfg.denoise, batch_size=st.denoise_batch, device=device)
    raw_f = extract_features_numpy(st.clips, st.cfg.features, batch_size=st.features_batch,
                                   device=device)
    clean_f = extract_features_numpy(clean, st.cfg.features, batch_size=st.features_batch,
                                     device=device)
    return clean, raw_f, clean_f


def setup(ctx) -> State:
    st = State()
    p = ctx.params
    st.cfg = pipeline_config(ctx.config)
    st.denoise_batch, st.features_batch = p["denoise_batch"], p["features_batch"]
    st.clips = make_clips(ctx)
    st.out = one_pass(st, ctx.device)
    return st


def _spanned(st: State):
    """The gate's and the features' batch calls, each inside a benchmark
    span, with the clip lengths each call received counted; -> undo()."""
    import stutter_tpu_torch.denoise as dn
    import stutter_tpu_torch.ops.frontend as fe

    orig = (dn.denoise_batch, fe.extract_features_149_batch)
    st.counted = {"gate": [], "frontend": []}

    def gate(audio, lengths, *a, **k):
        with tracing.span("bench.gate"):
            out = orig[0](audio, lengths, *a, **k)
        st.counted["gate"].append(lengths.cpu().numpy())
        return out

    def frontend(audio, lengths, *a, **k):
        with tracing.span("bench.frontend"):
            out = orig[1](audio, lengths, *a, **k)
        st.counted["frontend"].append(lengths.cpu().numpy())
        return out

    dn.denoise_batch, fe.extract_features_149_batch = gate, frontend

    def undo():
        dn.denoise_batch, fe.extract_features_149_batch = orig

    return undo


def window(ctx, st: State) -> dict:
    p = ctx.params
    passes, t0, ends = 0, time.perf_counter(), []
    while True:
        st.out = one_pass(st, ctx.device)
        passes += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= ctx.seconds:
            break
    elapsed = ends[-1] - t0
    pass_s = np.diff([t0, *ends])
    trace = None
    if ctx.trace:
        undo = _spanned(st)
        try:
            with tracing.profile_window() as prof:
                with tracing.span(tracing.REGION):
                    for _ in range(p["trace_passes"]):
                        st.out = one_pass(st, ctx.device)
        finally:
            undo()
        lengths = {k: np.concatenate(v) if v else np.zeros(0, np.int64)
                   for k, v in st.counted.items()}
        trace = tracing.Trace.read(prof, ctx.chips, {
            "gate_lengths": lengths["gate"], "frontend_lengths": lengths["frontend"],
            "passes": p["trace_passes"], "clips": len(st.clips)})
    n = len(st.clips)
    return {"metrics": {"clips_per_s": stats.rate(n * passes, elapsed)},
            "attempted": n * passes, "failed": 0, "trace": trace,
            "detail": {"passes": passes, "elapsed_s": elapsed,
                       "pass_s": {"min": float(pass_s.min()), "median": float(np.median(pass_s)),
                                  "max": float(pass_s.max())}}}


def release(ctx, st: State) -> None:
    """The program's outputs are host arrays; it keeps nothing on the device
    but its small cached tables."""


def sampled(ctx, st: State) -> list[int]:
    longest = int(np.argmax([len(y) for y in st.clips]))
    return gen.sample(len(st.clips), ctx.params["check_clips"], ctx.seed, always=[longest])


def gaps(ref: tuple, got: tuple) -> dict:
    """Gaps of the program's outputs from the reference's: the clean audio
    (peak-normalised, so absolute), the MFCC block of the features over
    1 + |reference|, the chroma block absolute (it lies in [0, 1])."""
    (rc, rr, rcl), (gc, gr, gcl) = ref, got
    mf = max(float(np.max(np.abs(g[MFCC] - r[MFCC]) / (1.0 + np.abs(r[MFCC]))))
             for g, r in ((gr, rr), (gcl, rcl)))
    ch = max(float(np.max(np.abs(g[CHROMA] - r[CHROMA]))) for g, r in ((gr, rr), (gcl, rcl)))
    return {"gate_gap": float(np.max(np.abs(gc - rc))), "mfcc_gap": mf, "chroma_gap": ch}


def reference_outputs(ctx, y: np.ndarray) -> tuple:
    dn_cfg = denoise_config(ctx.config["denoise"])
    fe = ctx.config["frontend"]
    with torch.no_grad():
        clean = dsp.denoise_clip(y, dn_cfg, ctx.device)
        return (clean, dsp.features_149_clip(y, fe, ctx.device),
                dsp.features_149_clip(clean, fe, ctx.device))


def worst(rows: list[dict]) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def compare(ctx, st: State) -> list[dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clean, raw_f, clean_f = st.out
    rows = [gaps(reference_outputs(ctx, st.clips[i]), (clean[i], raw_f[i], clean_f[i]))
            for i in sampled(ctx, st)]
    w, lim = worst(rows), ctx.params["limits"]
    # the clean audio's own gap is reported, not judged: no lower precision
    # moves an FFT, so it has no control reading; the clean features,
    # each side's from its own clean audio, judge the gate
    st.notes = {"gate_gap": w["gate_gap"]}
    return [{"name": k, "value": w[k], "limit": lim[k], "ok": w[k] <= lim[k]} for k in lim]


def control(ctx, seeds: list[int], n_clips: int) -> list[dict]:
    """The control at the cell's size: on each seed, the reference in TF32
    in the program's place, judged as the program is, on `n_clips` sampled
    clips -> per seed the gaps."""
    out = []
    for seed in seeds:
        ctx.seed = seed
        st = State()
        st.clips = make_clips(ctx)
        rows = []
        for i in gen.sample(len(st.clips), n_clips, seed,
                            always=[int(np.argmax([len(y) for y in st.clips]))]):
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            exact = reference_outputs(ctx, st.clips[i])
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                low = reference_outputs(ctx, st.clips[i])
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            rows.append(gaps(exact, low))
        out.append({"seed": seed, **worst(rows)})
    return out
