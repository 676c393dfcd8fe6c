"""The W2V-BERT cell's yardstick and check on the CPU at a small size: the
counts of counts/w2v_bert.py against a hand count, the port's own
counters against the counts' frames and pairs, and a whole run of
w2v_bert_2.corpus (the look for a chip skipped) that is correct when
sound, and not when the relative-key term is dropped or the gate's
threshold is off."""

import json
from pathlib import Path

import numpy as np

import run
from counts import w2v_bert as C
from counts.work import bound_s, fft_ops

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
# the whole-run checks' widths: the published head width of 64, so the
# relative-key term weighs in the scores as at the published size
RUN_SMALL = {"hidden_size": 256, "num_hidden_layers": 2, "num_attention_heads": 4,
             "intermediate_size": 512}
SMALL = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 128}


def small_encoder() -> dict:
    enc = json.loads((CONFIGS / "w2v_bert_2.json").read_text())["encoder"]
    return {**enc, **SMALL}


def test_counts_of_one_clip_by_hand():
    """One 0.5 s clip at the small widths: 8000 samples give 48 fbank
    frames and 24 encoder frames; every stage by hand."""
    enc = small_encoder()
    assert C.fbank_frames(8000) == 48 and C.n_frames(8000) == 24
    assert C.n_frames(559) == 0 and C.n_frames(560) == 1 and C.n_frames(399) == 0
    s = C.encoder_stages(8000, enc)
    T, Fr, d, f, h, L = 24, 48, 64, 128, 4, 2
    assert s["fbank"] == (8000 + Fr * (6 * 400 + fft_ops(512) + 3 * 257 + 2 * 257 * 80 + 8 * 80),
                          4 * (8000 + T * 160))
    assert s["projection"] == (7 * 160 * T + 2 * T * 160 * d, 4 * T * (160 + d))
    assert s["ffn"] == (2 * L * (7 * T * d + 4 * T * d * f + 4 * T * f + 2 * T * d),
                        2 * L * 4 * (3 * T * d + 2 * T * f))
    attn = T * 2 * d * 73 + h * T * T * 8 + 4 * T * T * d
    assert s["attention"] == (L * attn, L * 4 * 4 * T * d)
    assert s["layers"] == (L * (7 * T * d + 8 * T * d * d + 2 * T * d), L * 4 * 10 * T * d)
    assert s["conv_pointwise1"] == (L * 4 * T * d * d, L * 4 * 3 * T * d)
    assert s["conv_depthwise"] == (L * 2 * 31 * T * d, L * 4 * 2 * T * d)
    assert s["conv_pointwise2"] == (L * 2 * T * d * d, L * 4 * 2 * T * d)
    assert s["conv_glu"] == (L * 4 * T * d, L * 4 * 3 * T * d)
    assert s["conv_norm"] == (L * 8 * T * d, L * 4 * 2 * T * d)
    assert s["conv_norm_swish"] == (L * 11 * T * d, L * 4 * 2 * T * d)
    assert s["final"] == (L * 7 * T * d + T * d, 4 * (L * 2 * T * d + T * d + d))
    assert C.pairs([8000, 399, 8000]) == (48, 2 * 24 * 24)
    assert C.encoder_work([559], enc) == {}
    assert C.attention_bound_s([8000], enc) == bound_s(*s["attention"])
    assert C.conv_module_bound_s([8000], enc) == sum(bound_s(*s[k]) for k in C.CONV_STAGES)


def test_published_widths_reckon_the_corpus_pass():
    """At the published widths, over embed_905's lengths at the default
    buckets' cap: 104,330 valid frames; about 121 TFLOP of GEMMs and 1.5
    of attention, under a TFLOP of conv module
    outside its GEMMs."""
    import gen

    cfg = json.loads((CONFIGS / "w2v_bert_2.json").read_text())
    mix = json.loads((CONFIGS.parent / "mixes" / "embed_905_w2v.json").read_text())
    n = [min(int(d * 16000), 163840) for d in gen.lengths_s(905, mix["lengths"])]
    enc = cfg["encoder"]
    frames, _ = C.pairs(n)
    assert frames == 104330
    w = C.encoder_work(n, enc)
    gemm = sum(w[k][0] for k in ("ffn", "layers", "conv_pointwise1", "conv_pointwise2"))
    assert 120e12 < gemm < 123e12
    assert 1.0e12 < w["attention"][0] < 2.0e12
    assert w["conv_depthwise"][0] < 1e12


def test_the_ports_counters_equal_the_counts():
    """A traced extraction at the small widths counts the frames and pairs
    counts/w2v_bert.py reckons from the clips' lengths (mfu.w2v_bert reads
    the lengths)."""
    from torch.profiler import ProfilerActivity, profile

    from stutter_tpu_torch.config import EmbeddingFeatureConfig, W2VBertConfig
    from stutter_tpu_torch.models import w2v_bert
    from stutter_tpu_torch.ops.frontend import extract_features_numpy
    from stutter_tpu_torch.utils import profiling

    enc = small_encoder()
    cfg = W2VBertConfig(**{k: v for k, v in enc.items() if k in W2VBertConfig.__dataclass_fields__})
    rng = np.random.RandomState(3)
    clips = [rng.randn(n).astype(np.float32) for n in (8000, 30000, 52000, 400, 120000)]
    before = profiling.counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            extract_features_numpy(clips, EmbeddingFeatureConfig(encoder=cfg), batch_size=2,
                                   device="cpu")
    finally:
        w2v_bert.release()
    got = {k: v - before.get(k, 0) for k, v in profiling.counters().items()}
    assert (got["w2v_bert.valid_frames"], got["w2v_bert.attn_pairs_valid"]) == C.pairs(
        [len(y) for y in clips])


def run_small(seed: int = 2**31 + 29):
    ctx = run.Ctx("w2v_bert_2.corpus", seed, 1.0, False, "cpu",
                  overrides={"clips": 6, "check_clips": 3})
    ctx.config["encoder"].update(RUN_SMALL)
    ctx.config["feature_dim"] = RUN_SMALL["hidden_size"] + 5
    ctx.config["mlp"]["dims"][0] = RUN_SMALL["hidden_size"] + 5
    return run.run(ctx, require_chip=False)


def test_a_sound_run_is_correct():
    code, res = run_small()
    assert code == 0 and res["correct"] and res["failed"] == 0
    assert set(res["checks"]) == {"embed_gap", "proba_gap", "gate_gap"}
    assert set(res["metrics"]) == {"clips_per_s", "setup_s"}


def test_a_run_with_the_relative_key_term_dropped_is_not_correct(monkeypatch):
    import torch

    from stutter_tpu_torch.models import w2v_bert

    monkeypatch.setattr(w2v_bert, "rel_key_scores", lambda q, d, idx: torch.zeros(
        *q.shape[:2], *idx.shape))
    code, res = run_small()
    assert code == 0 and not res["correct"]
    assert res["checks"]["embed_gap"]["value"] > res["checks"]["embed_gap"]["limit"]


def test_a_run_with_the_gates_threshold_off_is_not_correct(monkeypatch):
    """The program's gate with its threshold moved by 1 % (the control's
    gate_threshold fault): the encoder's gaps stay within their limits, as
    the reference encodes the program's clean clip, and gate_gap fails."""
    import dataclasses

    import stutter_tpu_torch.denoise as dn

    orig = dn.denoise_batch

    def off(audio, lengths, cfg, *a, **k):
        cfg = dataclasses.replace(
            cfg, thresh_n_mult_nonstationary=cfg.thresh_n_mult_nonstationary + 0.02)
        return orig(audio, lengths, cfg, *a, **k)

    monkeypatch.setattr(dn, "denoise_batch", off)
    code, res = run_small()
    assert code == 0 and not res["correct"]
    checks = res["checks"]
    assert checks["gate_gap"]["value"] > checks["gate_gap"]["limit"]
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in ("embed_gap", "proba_gap"))


def test_attn_pad_waste_reads_the_w2v_bert_counters(monkeypatch):
    """attn_pad_waste.w2v_bert is w2v_bert.attn_pairs_sent over
    attn_pairs_valid of the traced window, and nothing where the port
    counts no W2V-BERT pairs (a program without the encoder)."""
    import tracing
    from stutter_tpu_torch.utils import profiling

    tid = 7
    spans = [profiling.SpanRecord("denoise_batch", 100_000, 300_000, tid)]
    trace = tracing.Trace([], [tracing.Span(tracing.REGION, 0.0, 1000.0, tid),
                               tracing.Span("bench.gate", 110.0, 200.0, tid)],
                          (0.0, 1000.0), 1, {})
    reader = run.load_module(run.BENCH / "metrics" / "attn_pad_waste.w2v_bert.py", "r_apw")
    ctx = run.Ctx("w2v_bert_2.corpus", 1, 1.0, True, "cpu")
    monkeypatch.setattr(profiling, "spans", lambda: list(spans), raising=False)
    for counters, want in (({"w2v_bert.attn_pairs_sent": 1281, "w2v_bert.attn_pairs_valid": 1000,
                             "wavlm.attn_pairs_sent": 9, "wavlm.attn_pairs_valid": 3}, 1.281),
                           ({"wavlm.attn_pairs_sent": 9, "wavlm.attn_pairs_valid": 3}, None)):
        monkeypatch.setattr(profiling, "counters", lambda c=counters: dict(c))
        assert reader.read(trace, ctx) == want
