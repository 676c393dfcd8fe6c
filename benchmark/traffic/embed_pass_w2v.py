"""Kind `embed_pass_w2v`: embed_pass (traffic/embed_pass.py) with W2V-BERT
2.0 as the encoder: passes over a corpus held in memory through the gate
(`denoise.denoise_clips`), the encoder's clip embeddings
(`ops.frontend.extract_features_numpy` with an EmbeddingFeatureConfig whose
encoder is a W2VBertConfig: the fbank and the Conformer through
run_bucketed, the weights one copy per device) and the seeded MLP, each
with device "cuda".

Everything but the encoder and the check's input is embed_pass's own,
imported from it: the clips, the MLP's weights, the sample of clips
checked and the gaps.  Set-up draws the encoder's weights by reference/w2v_bert.py's
draw_params (every bias and LayerNorm away from its published constant)
on the first device, hands them to the port as the checkpoint's .npz
(persist.save_wavlm into TMPDIR, named by W2VBertConfig.weights), and
runs one pass, which loads them, builds the kernels and warms every shape.
A program without W2VBertConfig fails at set-up's first line.  The window
runs whole passes until --seconds have gone by; traced, the gate's
batches, the encoder's calls, each layer's attention core and conv module
sit inside the benchmark's spans `bench.gate`, `bench.encoder`,
`bench.attention` and `bench.conv_module`.

The check: embed_pass's sample of clips, the longest among them, through
the plain reference (the gate; the fbank and encoder one clip at a time
unpadded; the MLP) with the same weights, drawn again from the seed,
against the last pass's clean audio (gate_gap, max |got - ref|),
embeddings (embed_gap, max |got - ref| / (1 + |ref|)) and probabilities
(proba_gap, max |got - ref|), each judged.  The reference encodes the
clean clip the program's gate gave in that pass, not its own gate's, so
that embed_gap and proba_gap judge the encoder and the MLP and gate_gap
the gate: the two gates' clean audio differ by FP32 rounding (a few
1e-6), and the log-mel of the stretches the gate silences magnifies that
to as much as 1e-4 in an embedding (measured on an H100), over ten times
what the program's encoder adds on the same clean clip.  That magnified
shift, the reference's embedding of its own gate's clip against its
embedding of the program's, is reported as the detail
`gate_shift_embed_gap`.  The control runs the reference gate and encoder
in FP32 and again with TF32 matmuls and convs, the encoder of both on the
FP32 gate's clip, and judges the second as the program is judged; with a
`fault` (GATE_FAULTS) it instead puts the reference gate with one setting
off in the program's gate's place.
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

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import embed_pass as base  # noqa: E402  (puts the benchmark's folder on sys.path)
import gen  # noqa: E402
import stats  # noqa: E402
import tracing  # noqa: E402
from reference import dsp  # noqa: E402
from reference import w2v_bert as ref_w2v  # noqa: E402
from reference import wavlm as ref_wavlm  # noqa: E402
from reference.config import denoise_config  # noqa: E402

State = base.State
# faults planted in the gate for the control: a setting of the `denoise`
# group moved by this much
GATE_FAULTS = {"gate_threshold": ("thresh_n_mult_nonstationary", 0.02),
               "gate_blend": ("prop_decrease", -0.01)}
# what the port's encoder implements, beside the widths it takes
FIXED = {"hidden_act": "swish", "position_embeddings_type": "relative_key", "add_adapter": False,
         "use_intermediate_ffn_before_adapter": False}


def encoder_config(ctx, weights: str):
    """The port's W2VBertConfig: the configuration's widths, the weights of
    the .npz `weights`."""
    from stutter_tpu_torch.config import W2VBertConfig

    enc = ctx.config["encoder"]
    for k, v in FIXED.items():
        if enc.get(k, v) != v:
            raise ValueError(f"the port's W2V-BERT runs {k}={v!r}, the configuration has {enc[k]!r}")
    names = {f.name for f in dataclasses.fields(W2VBertConfig)}
    return W2VBertConfig(**{k: v for k, v in enc.items() if k in names}, weights=weights)


def encoder_params(ctx) -> dict:
    """The encoder's weights, drawn from the run's seed on the first
    device by the reference's draw_params, under the checkpoint's names."""
    seed = int(gen._rng(ctx.seed, 10).integers(0, 2**62))
    return ref_w2v.draw_params(ctx.config["encoder"], seed, base.first_device(ctx))


def pipeline_config(ctx, weights: str):
    from stutter_tpu_torch.config import (DenoiseConfig, EmbeddingFeatureConfig, FrontendConfig,
                                          PipelineConfig)

    fe = FrontendConfig(sample_rate=ctx.config["sample_rate"])
    return PipelineConfig(features=EmbeddingFeatureConfig(frontend=fe,
                                                          encoder=encoder_config(ctx, weights)),
                          denoise=DenoiseConfig(**ctx.config["denoise"]))


def setup(ctx) -> State:
    """The weights' .npz lives until the warm pass has loaded it: the
    first device reads it, every other device copies the first's."""
    from stutter_tpu_torch.config import W2VBertConfig  # noqa: F401  (a program without it stops here)
    from stutter_tpu_torch import persist
    from stutter_tpu_torch.models.mlp import SeedMLP

    st = State()
    p = ctx.params
    folder = tempfile.mkdtemp(prefix="w2v-bert-")
    try:
        weights = str(Path(folder) / "w2v_bert.npz")
        persist.save_wavlm(weights, encoder_params(ctx))
        st.cfg = pipeline_config(ctx, weights)
        st.denoise_batch, st.features_batch = p["denoise_batch"], p["features_batch"]
        st.clips = base.make_clips(ctx)
        st.mlp_params = base.mlp_params(ctx)
        st.mlp = SeedMLP.from_jax_params(st.mlp_params, device=ctx.device)
        st.mlp_device = st.mlp.weights[0].device
        st.out = one_pass(st, ctx.device)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return st


def one_pass(st: State, device: str) -> tuple:
    """embed_pass's pass, keeping the gate's clean clips (the check's
    input) in st.clean."""
    from stutter_tpu_torch.denoise import denoise_clips
    from stutter_tpu_torch.ops.frontend import extract_features_numpy

    st.clean = denoise_clips(st.clips, st.cfg.denoise, batch_size=st.denoise_batch,
                             device=device)
    rows = extract_features_numpy(st.clean, st.cfg.features, batch_size=st.features_batch,
                                  device=device)
    with torch.no_grad():
        proba = st.mlp(torch.from_numpy(rows).to(st.mlp_device)).cpu().numpy()
    return rows, proba


def _spanned(st: State):
    """The gate's batch calls, the encoder's, and each layer's attention core
    and conv module, each inside a benchmark span, with the clip lengths
    each gate and encoder call received; -> undo()."""
    import stutter_tpu_torch.denoise as dn
    from stutter_tpu_torch.models import w2v_bert

    orig = (dn.denoise_batch, w2v_bert.encode, w2v_bert.relkey_attention, w2v_bert.conv_module)
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

    def conv_module(*a, **k):
        with tracing.span("bench.conv_module"):
            return orig[3](*a, **k)

    dn.denoise_batch, w2v_bert.encode = gate, encode
    w2v_bert.relkey_attention, w2v_bert.conv_module = attention, conv_module

    def undo():
        dn.denoise_batch, w2v_bert.encode, w2v_bert.relkey_attention, w2v_bert.conv_module = orig

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
    from stutter_tpu_torch.models import w2v_bert

    w2v_bert.release()
    del st.mlp


def reference_gate(ctx, y: np.ndarray, fault: str | None = None) -> np.ndarray:
    """The plain reference's clean clip (with a GATE_FAULTS setting moved)."""
    group = dict(ctx.config["denoise"])
    if fault is not None:
        key, shift = GATE_FAULTS[fault]
        group[key] += shift
    return dsp.denoise_clip(y, denoise_config(group), ctx.device)


def reference_outputs(ctx, params: dict, mlp: dict, clean: np.ndarray,
                      tf32: bool = False) -> tuple:
    """(clean clip, embedding, probabilities) of the plain reference on a
    clean clip: the fbank and encoder (in TF32 if `tf32`), the MLP over the
    embedding and the zero text placeholders."""
    n = len(mlp) // 2
    w = [torch.as_tensor(mlp[f"w{i}"], device=ctx.device) for i in range(n)]
    b = [torch.as_tensor(mlp[f"b{i}"], device=ctx.device) for i in range(n)]
    with torch.no_grad():
        e = ref_w2v.embed(params, clean, ctx.config["encoder"], tf32=tf32)
        row = torch.cat([e, e.new_zeros(ctx.config["feature_dim"] - e.shape[0])])
        return clean, e.cpu().numpy(), ref_wavlm.mlp_proba(w, b, row).cpu().numpy()


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def compare(ctx, st: State) -> list[dict]:
    _tf32(False)
    rows_out, proba = st.out
    dim = st.cfg.features.encoder.hidden_size
    params = encoder_params(ctx)
    rows, shift = [], 0.0
    for i in base.sampled(ctx, st):
        _, e, p = reference_outputs(ctx, params, st.mlp_params, st.clean[i])
        clean = reference_gate(ctx, st.clips[i])
        _, own, _ = reference_outputs(ctx, params, st.mlp_params, clean)
        shift = max(shift, float(np.max(np.abs(own - e) / (1.0 + np.abs(e)))))
        rows.append(base.gaps((clean, e, p), (st.clean[i], rows_out[i, :dim], proba[i])))
    w, lim = base.worst(rows), ctx.params["limits"]
    st.notes = {"gate_shift_embed_gap": shift}  # reported, not judged
    return [{"name": k, "value": w[k], "limit": lim[k], "ok": w[k] <= lim[k]} for k in lim]


def control(ctx, seeds: list[int], n_clips: int, fault: str | None = None) -> list[dict]:
    """The control at the cell's size: on each seed, the reference's gate,
    fbank, encoder and MLP with TF32 matmuls and convs in the program's
    place, its encoder on the FP32 gate's clean clip (weights drawn as the
    cell draws them), judged as the program is, on `n_clips` sampled clips
    -> per seed the gaps.  With `fault`, the reference gate with that
    GATE_FAULTS setting moved in the program's gate's place instead, in
    FP32, the encoder of both on its clip as the check runs them."""
    out = []
    for seed in seeds:
        ctx.seed = seed
        st = State()
        st.clips = base.make_clips(ctx)
        params = encoder_params(ctx)
        mlp = base.mlp_params(ctx)
        rows = []
        for i in base.sampled(ctx, st):
            _tf32(False)
            clean = reference_gate(ctx, st.clips[i])
            if fault is not None:
                got = reference_outputs(ctx, params, mlp, reference_gate(ctx, st.clips[i], fault))
                rows.append(base.gaps((clean, *got[1:]), got))
                continue
            exact = reference_outputs(ctx, params, mlp, clean)
            _tf32(True)
            try:
                low = (reference_gate(ctx, st.clips[i]),
                       *reference_outputs(ctx, params, mlp, clean, tf32=True)[1:])
            finally:
                _tf32(False)
            rows.append(base.gaps(exact, low))
        out.append({"seed": seed, **({"fault": fault} if fault else {}), **base.worst(rows)})
        del params
    return out
