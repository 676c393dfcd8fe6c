"""Kind `embed_pass_parakeet`: embed_pass (traffic/embed_pass.py) with
Parakeet-CTC-1.1B's encoder over whole long-form recordings: passes over
recordings held in memory through the gate (`denoise.denoise_clips`,
which pads a recording past the largest bucket to a multiple of it and
hands it back whole), the encoder's embeddings
(`ops.frontend.extract_features_numpy` with an EmbeddingFeatureConfig
whose encoder is a ParakeetConfig: the log-mel, the stem and the
FastConformer blocks through run_bucketed, each recording whole up to the
batch_fn's max_samples, the weights one copy per device) and the seeded
MLP, each with device "cuda".

Everything but the encoder, the gate's reference and the check's input is
embed_pass_w2v's and embed_pass's own, imported from them.  Set-up draws
the encoder's weights by reference/parakeet.py's draw_params on the first
device, hands them to the port as the checkpoint's .npz, and runs one
pass, which loads them, builds the kernels and warms every shape, with
the samples each encode call receives noted.  A program without
ParakeetConfig fails at set-up's first line.  The window runs whole
passes until --seconds have gone by; traced, the gate's batches, the
encoder's calls, each layer's attention core and conv module sit inside
the benchmark's spans `bench.gate`, `bench.encoder`, `bench.attention`
and `bench.conv_module`.

The check: embed_pass's sample of recordings, the longest among them,
through the plain reference (the gate at the recording's own padded
length, a multiple of the largest bucket as the program pads it; the
log-mel and encoder one recording at a time unpadded; the MLP) with the
same weights, drawn again from the seed, against the last pass's clean
audio (gate_gap), embeddings (embed_gap) and probabilities (proba_gap);
the reference encodes the program's clean recording, as embed_pass_w2v's
does (the reason is there).  Judged beside them: cut_samples, the
recordings' samples less those the warm pass's encode calls received (0:
every recording reached the gate and the encoder whole).  Reported:
gate_shift_embed_gap, sum T_i, and in a traced run the port's own counts
of the traced pass (`parakeet.valid_frames`, `sent_frames`,
`<owner>.cut_samples`).
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
import embed_pass_w2v as w2v  # noqa: E402
import gen  # noqa: E402
import stats  # noqa: E402
import tracing  # noqa: E402
from counts import parakeet as counts  # noqa: E402
from reference import dsp  # noqa: E402
from reference import parakeet as ref_pk  # noqa: E402
from reference import wavlm as ref_wavlm  # noqa: E402
from reference.config import denoise_config  # noqa: E402

State = base.State
GATE_FAULTS = w2v.GATE_FAULTS
# what the port's encoder implements, beside the widths it takes
FIXED = {"hidden_act": "silu", "attention_bias": True}
GATE_BUCKET = dsp.BUCKETS[-1]  # the program's gate pads a longer recording to a multiple


def encoder_config(ctx, weights: str):
    """The port's ParakeetConfig: the configuration's widths, the weights of
    the .npz `weights`."""
    from stutter_tpu_torch.config import ParakeetConfig

    enc = ctx.config["encoder"]
    for k, v in FIXED.items():
        if enc.get(k, v) != v:
            raise ValueError(f"the port's Parakeet runs {k}={v!r}, the configuration has {enc[k]!r}")
    names = {f.name for f in dataclasses.fields(ParakeetConfig)}
    return ParakeetConfig(**{k: v for k, v in enc.items() if k in names}, weights=weights)


def encoder_params(ctx) -> dict:
    """The encoder's weights, drawn from the run's seed on the first
    device by the reference's draw_params, under the checkpoint's names."""
    seed = int(gen._rng(ctx.seed, 10).integers(0, 2**62))
    return ref_pk.draw_params(ctx.config["encoder"], seed, base.first_device(ctx))


def pipeline_config(ctx, weights: str):
    from stutter_tpu_torch.config import (DenoiseConfig, EmbeddingFeatureConfig, FrontendConfig,
                                          PipelineConfig)

    fe = FrontendConfig(sample_rate=ctx.config["sample_rate"])
    return PipelineConfig(features=EmbeddingFeatureConfig(frontend=fe,
                                                          encoder=encoder_config(ctx, weights)),
                          denoise=DenoiseConfig(**ctx.config["denoise"]))


def setup(ctx) -> State:
    """The weights' .npz lives until the warm pass has loaded it; the warm
    pass's encode calls are watched for the samples they received
    (st.received)."""
    from stutter_tpu_torch.config import ParakeetConfig  # noqa: F401  (a program without it stops here)

    from stutter_tpu_torch import persist
    from stutter_tpu_torch.models import parakeet
    from stutter_tpu_torch.models.mlp import SeedMLP

    st = State()
    p = ctx.params
    folder = tempfile.mkdtemp(prefix="parakeet-")
    try:
        weights = str(Path(folder) / "parakeet.npz")
        persist.save_wavlm(weights, encoder_params(ctx))
        st.cfg = pipeline_config(ctx, weights)
        st.denoise_batch, st.features_batch = p["denoise_batch"], p["features_batch"]
        st.clips = base.make_clips(ctx)
        st.mlp_params = base.mlp_params(ctx)
        st.mlp = SeedMLP.from_jax_params(st.mlp_params, device=ctx.device)
        st.mlp_device = st.mlp.weights[0].device
        encode, st.received = parakeet.encode, []

        def watched(p, audio, lengths, *a, **k):
            st.received.append(int(lengths.sum()))
            return encode(p, audio, lengths, *a, **k)

        parakeet.encode = watched
        try:
            st.out = w2v.one_pass(st, ctx.device)
        finally:
            parakeet.encode = encode
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return st


def _spanned(st: State):
    """The gate's batch calls, the encoder's, and each layer's attention core
    and conv module, each inside a benchmark span, with the lengths each
    gate and encoder call received; -> undo()."""
    import stutter_tpu_torch.denoise as dn
    from stutter_tpu_torch.models import parakeet

    orig = (dn.denoise_batch, parakeet.encode, parakeet.xl_attention, parakeet.conv_module)
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

    dn.denoise_batch, parakeet.encode = gate, encode
    parakeet.xl_attention, parakeet.conv_module = attention, conv_module

    def undo():
        dn.denoise_batch, parakeet.encode, parakeet.xl_attention, parakeet.conv_module = orig

    return undo


def window(ctx, st: State) -> dict:
    """embed_pass_w2v's window: whole passes until --seconds, then (traced)
    one pass inside this kind's spans."""
    p = ctx.params
    passes, t0, ends = 0, time.perf_counter(), []
    while True:
        st.out = w2v.one_pass(st, ctx.device)
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
                        st.out = w2v.one_pass(st, ctx.device)
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
    from stutter_tpu_torch.models import parakeet

    parakeet.release()
    del st.mlp


def reference_gate(ctx, y: np.ndarray, fault: str | None = None) -> np.ndarray:
    """The plain reference's clean recording (with a GATE_FAULTS setting
    moved), gated at the length the program pads it to: its bucket, or a
    multiple of the largest bucket past it."""
    group = dict(ctx.config["denoise"])
    if fault is not None:
        key, shift = GATE_FAULTS[fault]
        group[key] += shift
    n = len(y)
    N = dsp.pad_to_bucket(n) if n <= GATE_BUCKET else -(-n // GATE_BUCKET) * GATE_BUCKET
    buf = np.zeros((1, N), np.float32)
    buf[0, :n] = y
    audio = torch.from_numpy(buf).to(ctx.device)
    length = torch.tensor([n], dtype=torch.int32, device=ctx.device)
    return dsp.denoise(audio, length, denoise_config(group))[0, :n].cpu().numpy()


def reference_outputs(ctx, params: dict, mlp: dict, clean: np.ndarray,
                      tf32: bool = False) -> tuple:
    """(clean recording, embedding, probabilities) of the plain reference
    on a clean recording: the log-mel and encoder (in TF32 if `tf32`), the
    MLP over the embedding and the zero text placeholders."""
    n = len(mlp) // 2
    w = [torch.as_tensor(mlp[f"w{i}"], device=ctx.device) for i in range(n)]
    b = [torch.as_tensor(mlp[f"b{i}"], device=ctx.device) for i in range(n)]
    with torch.no_grad():
        e = ref_pk.embed(params, clean, ctx.config["encoder"], tf32=tf32)
        row = torch.cat([e, e.new_zeros(ctx.config["feature_dim"] - e.shape[0])])
        return clean, e.cpu().numpy(), ref_wavlm.mlp_proba(w, b, row).cpu().numpy()


def compare(ctx, st: State) -> list[dict]:
    w2v._tf32(False)
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
    # what the gate and the encoder's path cut, by the samples that came
    # back from the gate and those the warm pass's encode calls received
    w["cut_samples"] = float(sum(len(y) for y in st.clips) - sum(getattr(st, "received", [0])))
    st.notes = {"gate_shift_embed_gap": shift,  # reported, not judged
                "frames_sum_T": counts.pairs([len(y) for y in st.clips])[0],
                "port_counters": port_counters()}
    return [{"name": k, "value": w[k], "limit": lim[k], "ok": w[k] <= lim[k]} for k in lim]


def port_counters() -> dict:
    """The port's own counts of the traced pass (none untraced): the
    encoder's valid and sent frames and what each caller's cap cut."""
    try:
        from stutter_tpu_torch.utils import profiling
    except ImportError:
        return {}
    names = ("parakeet.valid_frames", "parakeet.sent_frames", "denoise_clips.cut_samples",
             "run_bucketed.cut_samples")
    got = profiling.counters() if hasattr(profiling, "counters") else {}
    return {k: got[k] for k in names if k in got}


def control(ctx, seeds: list[int], n_clips: int, fault: str | None = None) -> list[dict]:
    """embed_pass_w2v's control with this kind's gate and encoder: the
    reference in TF32 in the program's place on the FP32 gate's clean
    recording, or (`fault`) the reference gate with a GATE_FAULTS setting
    moved in the program's gate's place."""
    out = []
    for seed in seeds:
        ctx.seed = seed
        st = State()
        st.clips = base.make_clips(ctx)
        params = encoder_params(ctx)
        mlp = base.mlp_params(ctx)
        rows = []
        for i in base.sampled(ctx, st):
            w2v._tf32(False)
            clean = reference_gate(ctx, st.clips[i])
            if fault is not None:
                got = reference_outputs(ctx, params, mlp, reference_gate(ctx, st.clips[i], fault))
                rows.append(base.gaps((clean, *got[1:]), got))
                continue
            exact = reference_outputs(ctx, params, mlp, clean)
            w2v._tf32(True)
            try:
                low = (reference_gate(ctx, st.clips[i]),
                       *reference_outputs(ctx, params, mlp, clean, tf32=True)[1:])
            finally:
                w2v._tf32(False)
            rows.append(base.gaps(exact, low))
        out.append({"seed": seed, **({"fault": fault} if fault else {}), **base.worst(rows)})
        del params
    return out
