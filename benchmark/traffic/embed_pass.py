"""Kind `embed_pass`: passes over a corpus held in memory through a speech
encoder's clip embeddings and the feature MLP, as a batch user embeds and
classifies a corpus -- the device half of the port's `preprocess` plus
`extract_corpus` with an EmbeddingFeatureConfig, then the MLP.

A pass: `denoise.denoise_clips` over every clip (batches of
`denoise_batch`), then `ops.frontend.extract_features_numpy` over the
clean clips with the configuration's encoder (batches of
`features_batch`: run_bucketed, the encoder's weights one copy per
device), then the seeded MLP over the rows, each with device "cuda", so
the mesh is every visible GPU.  Set-up makes the clips, the encoder's
weights and the MLP's from the seed, here and not by the port: the
encoder's by the reference's draw_params (every bias, LayerNorm, gate
constant and weight norm g away from its published constant), handed to
the port as the checkpoint's .npz (persist.save_wavlm into TMPDIR, named by
WavLMConfig.weights); the MLP's in numpy, biases included.  It then runs
one pass, which loads the weights, builds the kernels and warms every
shape.  The window runs whole passes until --seconds have
gone by; a clip counts when its class probabilities are on the host.

The check: a sample of clips drawn from the seed, the longest among them,
through the plain reference (the gate, the encoder one clip at a time
unpadded, the MLP) with the same weights, drawn again from the seed,
against the last pass's
embeddings (max |got - ref| / (1 + |ref|)) and probabilities (max |got -
ref|).
"""

from __future__ import annotations

import dataclasses
import shutil
import sys
import tempfile
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
from reference import wavlm as ref_wavlm  # noqa: E402
from reference.config import denoise_config  # noqa: E402


class State:
    pass


def encoder_config(ctx, weights: str):
    """The port's WavLMConfig: the configuration's widths, the weights of
    the .npz `weights`."""
    from stutter_tpu_torch.config import WavLMConfig

    names = {f.name for f in dataclasses.fields(WavLMConfig)}
    enc = {k: tuple(v) if isinstance(v, list) else v for k, v in ctx.config["encoder"].items()
           if k in names}
    return WavLMConfig(**enc, weights=weights)


def first_device(ctx) -> str:
    return "cuda:0" if ctx.device == "cuda" else ctx.device


def encoder_params(ctx) -> dict:
    """The encoder's weights, drawn from the run's seed on the first
    device by the reference's draw_params, under the checkpoint's names."""
    seed = int(gen._rng(ctx.seed, 10).integers(0, 2**62))
    return ref_wavlm.draw_params(ctx.config["encoder"], seed, first_device(ctx))


def pipeline_config(ctx, weights: str):
    from stutter_tpu_torch.config import (DenoiseConfig, EmbeddingFeatureConfig, FrontendConfig,
                                          PipelineConfig)

    fe = FrontendConfig(sample_rate=ctx.config["sample_rate"])
    return PipelineConfig(features=EmbeddingFeatureConfig(frontend=fe,
                                                          encoder=encoder_config(ctx, weights)),
                          denoise=DenoiseConfig(**ctx.config["denoise"]))


def make_clips(ctx) -> list[np.ndarray]:
    p, sr = ctx.params, ctx.config["sample_rate"]
    durs = gen.lengths_s(p["clips"], p["lengths"])
    return [gen.recording_clip(ctx.seed, i, int(d * sr), sr) for i, d in enumerate(durs)]


def mlp_params(ctx) -> dict:
    """The MLP's stacked weights ({w0 [S, d_in, d_out], b0 [S, d_out], ...},
    seed axis first), drawn from the run's seed: weights He-normal (std
    sqrt(2 / d_in)), biases N(0, 0.1)."""
    m = ctx.config["mlp"]
    rng, S, dims = gen._rng(ctx.seed, 9), m["n_seeds"], m["dims"]
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = (rng.standard_normal((S, a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
        out[f"b{i}"] = (rng.standard_normal((S, b)) * 0.1).astype(np.float32)
    return out


def one_pass(st: State, device: str) -> tuple:
    from stutter_tpu_torch.denoise import denoise_clips
    from stutter_tpu_torch.ops.frontend import extract_features_numpy

    clean = denoise_clips(st.clips, st.cfg.denoise, batch_size=st.denoise_batch, device=device)
    rows = extract_features_numpy(clean, st.cfg.features, batch_size=st.features_batch,
                                  device=device)
    with torch.no_grad():
        proba = st.mlp(torch.from_numpy(rows).to(st.mlp_device)).cpu().numpy()
    return rows, proba


def setup(ctx) -> State:
    """The weights' .npz lives until the warm pass has loaded it: the
    first device reads it, every other device copies the first's."""
    from stutter_tpu_torch import persist
    from stutter_tpu_torch.models.mlp import SeedMLP

    st = State()
    p = ctx.params
    folder = tempfile.mkdtemp(prefix="wavlm-")
    try:
        weights = str(Path(folder) / "wavlm.npz")
        persist.save_wavlm(weights, encoder_params(ctx))
        st.cfg = pipeline_config(ctx, weights)
        st.denoise_batch, st.features_batch = p["denoise_batch"], p["features_batch"]
        st.clips = make_clips(ctx)
        st.mlp_params = mlp_params(ctx)
        st.mlp = SeedMLP.from_jax_params(st.mlp_params, device=ctx.device)
        st.mlp_device = st.mlp.weights[0].device
        st.out = one_pass(st, ctx.device)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return st


def _spanned(st: State):
    """The gate's batch calls, the encoder's and each layer's attention
    core, each inside a benchmark span, with the clip lengths each gate and
    encoder call received and the MLP's rows counted; -> undo()."""
    import stutter_tpu_torch.denoise as dn
    from stutter_tpu_torch.models import wavlm

    orig = (dn.denoise_batch, wavlm.encode, wavlm.gated_attention)
    st.counted = {"gate": [], "encoder": []}

    def gate(audio, lengths, *a, **k):
        with tracing.span("bench.gate"):
            out = orig[0](audio, lengths, *a, **k)
        st.counted["gate"].append(lengths.cpu().numpy())
        return out

    def encode(p, audio, lengths, *a, **k):
        with tracing.span("bench.encoder"):
            out = orig[1](p, audio, lengths, *a, **k)
        st.counted["encoder"].append(lengths.cpu().numpy())
        return out

    def attention(*a, **k):
        with tracing.span("bench.attention"):
            return orig[2](*a, **k)

    dn.denoise_batch, wavlm.encode, wavlm.gated_attention = gate, encode, attention

    def undo():
        dn.denoise_batch, wavlm.encode, wavlm.gated_attention = orig

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
            "gate_lengths": lengths["gate"], "encoder_lengths": lengths["encoder"],
            "mlp_rows": len(st.clips) * p["trace_passes"], "passes": p["trace_passes"],
            "clips": len(st.clips)})
    n = len(st.clips)
    return {"metrics": {"clips_per_s": stats.rate(n * passes, elapsed)},
            "attempted": n * passes, "failed": 0, "trace": trace,
            "detail": {"passes": passes, "elapsed_s": elapsed,
                       "pass_s": {"min": float(pass_s.min()), "median": float(np.median(pass_s)),
                                  "max": float(pass_s.max())}}}


def release(ctx, st: State) -> None:
    """Drops the encoder's weights on every device, and the MLP."""
    from stutter_tpu_torch.models import wavlm

    wavlm.release()
    del st.mlp


def sampled(ctx, st: State) -> list[int]:
    longest = int(np.argmax([len(y) for y in st.clips]))
    return gen.sample(len(st.clips), ctx.params["check_clips"], ctx.seed, always=[longest])


def reference_outputs(ctx, params: dict, mlp: dict, y: np.ndarray) -> tuple:
    """(clean clip, embedding, probabilities) of the plain reference: the
    gate, the encoder on the clean clip, the MLP over the embedding and the
    zero text placeholders."""
    enc = ctx.config["encoder"]
    n = len(mlp) // 2
    w = [torch.as_tensor(mlp[f"w{i}"], device=ctx.device) for i in range(n)]
    b = [torch.as_tensor(mlp[f"b{i}"], device=ctx.device) for i in range(n)]
    with torch.no_grad():
        clean = dsp.denoise_clip(y, denoise_config(ctx.config["denoise"]), ctx.device)
        e = ref_wavlm.embed(params, clean, enc)
        row = torch.cat([e, e.new_zeros(ctx.config["feature_dim"] - e.shape[0])])
        return clean, e.cpu().numpy(), ref_wavlm.mlp_proba(w, b, row).cpu().numpy()


def gaps(ref: tuple, got: tuple) -> dict:
    """The embedding's gap over 1 + |reference|; the probabilities' absolute
    (they lie in [0, 1]); the clean audio's absolute (peak-normalised)."""
    (rc, re, rp), (gc, ge, gp) = ref, got
    out = {"embed_gap": float(np.max(np.abs(ge - re) / (1.0 + np.abs(re)))),
           "proba_gap": float(np.max(np.abs(gp - rp)))}
    if gc is not None:
        out["gate_gap"] = float(np.max(np.abs(gc - rc)))
    return out


def worst(rows: list[dict]) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def compare(ctx, st: State) -> list[dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows_out, proba = st.out
    dim = st.cfg.features.encoder.hidden_size
    params = encoder_params(ctx)
    rows = []
    for i in sampled(ctx, st):
        ref = reference_outputs(ctx, params, st.mlp_params, st.clips[i])
        rows.append(gaps(ref, (None, rows_out[i, :dim], proba[i])))
    w, lim = worst(rows), ctx.params["limits"]
    return [{"name": k, "value": w[k], "limit": lim[k], "ok": w[k] <= lim[k]} for k in lim]


def control(ctx, seeds: list[int], n_clips: int) -> list[dict]:
    """The control at the cell's size: on each seed, the reference in TF32
    in the program's place (weights drawn as the cell draws them), judged
    as the program is, on `n_clips` sampled clips -> per seed the gaps."""
    out = []
    for seed in seeds:
        ctx.seed = seed
        st = State()
        st.clips = make_clips(ctx)
        params = encoder_params(ctx)
        mlp = mlp_params(ctx)
        rows = []
        for i in sampled(ctx, st):
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            exact = reference_outputs(ctx, params, mlp, st.clips[i])
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                low = reference_outputs(ctx, params, mlp, st.clips[i])
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            rows.append(gaps(exact, low))
        out.append({"seed": seed, **worst(rows)})
        del params
    return out
