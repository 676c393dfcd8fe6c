"""The WavLM cell's yardstick and check on the CPU at a small size: the
counts of counts/wavlm.py against a hand count, the port's own counters
against the counts' frames and pairs, and a whole run of
wavlm_large.corpus (the look for a chip skipped) that is correct when
sound and not when the gate of the position bias is dropped."""

import json
from pathlib import Path

import numpy as np
import pytest

import run
from counts import wavlm as C
from counts.work import bound_s

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SMALL = {"conv_dim": [32] * 7, "hidden_size": 64, "num_hidden_layers": 2,
         "num_attention_heads": 4, "intermediate_size": 128}


def small_encoder() -> dict:
    enc = json.loads((CONFIGS / "wavlm_large.json").read_text())["encoder"]
    return {**enc, **SMALL}


def test_counts_of_one_clip_by_hand():
    """One 0.5 s clip at the small widths: 8000 samples give 1599, 799,
    399, 199, 99, 49, 24 frames; every stage by hand."""
    enc = small_encoder()
    assert C.conv_frames(8000, enc) == [1599, 799, 399, 199, 99, 49, 24]
    s = C.encoder_stages(8000, enc)
    T, d, f, h = 24, 64, 128, 4
    assert s["conv0"] == (2 * 1 * 10 * 32 * 1599 + 15 * 32 * 1599, 4 * (8000 + 32 * 1599))
    assert s["conv1"] == (2 * 32 * 3 * 32 * 799 + 15 * 32 * 799, 4 * (32 * 1599 + 32 * 799))
    assert s["projection"] == (7 * 32 * T + 2 * T * 32 * d, 4 * T * (32 + d))
    assert s["pos_conv"] == (2 * T * 4 * 128 * d + 9 * T * d, 4 * 2 * T * d)
    gate = T * h * (2 * 16 * 8 + 18)
    attn = gate + h * T * T * 8 + 4 * T * T * d
    assert s["attention"] == (2 * attn, 2 * 4 * 5 * T * d)
    assert s["layers"] == (2 * (14 * T * d + 8 * T * d * d + 2 * T * d), 2 * 4 * 8 * T * d)
    assert s["ffn"] == (2 * (4 * T * d * f + 8 * T * f), 2 * 4 * (2 * T * d + 2 * T * f))
    assert C.pairs([8000, 399, 8000], enc) == (48, 2 * 24 * 24)
    assert C.encoder_work([399], enc) == {}
    assert C.attention_bound_s([8000], enc) == bound_s(*s["attention"])
    assert C.mlp_ops(10, [69, 8, 3], 2) == 2 * 10 * 2 * (69 * 8 + 8 * 3)


def test_busy_time_is_the_union_of_the_kernels_intervals():
    """Kernels that overlap on one device (groups side by side on streams)
    count their union; devices add up."""
    from tracing import Kernel

    ks = [Kernel("a", 0.0, 10.0, 0, None, None), Kernel("b", 5.0, 12.0, 0, None, None),
          Kernel("c", 20.0, 25.0, 0, None, None), Kernel("d", 1.0, 2.0, 0, None, None),
          Kernel("e", 0.0, 4.0, 1, None, None)]
    assert abs(C.busy_s(ks) - 21e-6) < 1e-15
    assert C.busy_s([]) == 0.0


def test_published_widths_reckon_the_corpus_pass():
    """At the published widths, over corpus_905's lengths at the default
    buckets: 104,793 valid frames and 15,696,035 attention pairs, 2.0899x
    as many pairs sent, about 77.4 TFLOP."""
    import gen

    cfg = json.loads((CONFIGS / "wavlm_large.json").read_text())
    mix = json.loads((CONFIGS.parent / "mixes" / "embed_905.json").read_text())
    buckets = (24576, 49152, 98304, 163840)
    n = [int(d * 16000) for d in gen.lengths_s(905, mix["lengths"])]
    pad = [next((b for b in buckets if x <= b), buckets[-1]) for x in n]
    n = [min(x, b) for x, b in zip(n, pad)]
    enc = cfg["encoder"]
    assert C.pairs(n, enc) == (104793, 15696035)
    sent = sum(C.n_frames(b, enc) ** 2 for b in pad)
    assert round(sent / C.pairs(n, enc)[1], 4) == 2.0899
    assert 77.0e12 < C.encoder_ops(n, enc) < 77.8e12


def test_the_ports_counters_equal_the_counts():
    """A traced extraction at the small widths counts the frames and pairs
    counts/wavlm.py reckons from the clips' lengths (mfu.wavlm reads the
    lengths)."""
    from torch.profiler import ProfilerActivity, profile

    from stutter_tpu_torch.config import EmbeddingFeatureConfig, WavLMConfig
    from stutter_tpu_torch.models import wavlm
    from stutter_tpu_torch.ops.frontend import extract_features_numpy
    from stutter_tpu_torch.utils import profiling

    enc = small_encoder()
    cfg = WavLMConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in enc.items()
                         if k in WavLMConfig.__dataclass_fields__})
    rng = np.random.RandomState(3)
    clips = [rng.randn(n).astype(np.float32) for n in (8000, 30000, 52000, 400, 120000)]
    before = profiling.counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            extract_features_numpy(clips, EmbeddingFeatureConfig(encoder=cfg), batch_size=2,
                                   device="cpu")
    finally:
        wavlm.release()
    got = {k: v - before.get(k, 0) for k, v in profiling.counters().items()}
    assert (got["wavlm.valid_frames"], got["wavlm.attn_pairs_valid"]) == C.pairs(
        [len(y) for y in clips], enc)


def run_small(seed: int = 2**31 + 29):
    ctx = run.Ctx("wavlm_large.corpus", seed, 1.0, False, "cpu",
                  overrides={"clips": 6, "check_clips": 3})
    ctx.config["encoder"].update(SMALL)
    ctx.config["feature_dim"] = SMALL["hidden_size"] + 5
    ctx.config["mlp"]["dims"][0] = SMALL["hidden_size"] + 5
    return run.run(ctx, require_chip=False)


def test_a_sound_run_is_correct():
    code, res = run_small()
    assert code == 0 and res["correct"] and res["failed"] == 0
    assert set(res["checks"]) == {"embed_gap", "proba_gap"}
    assert set(res["metrics"]) == {"clips_per_s", "setup_s"}


def test_a_run_with_the_bias_gate_dropped_is_not_correct(monkeypatch):
    import torch

    from stutter_tpu_torch.models import wavlm

    monkeypatch.setattr(wavlm, "bias_gate", lambda p, i, x, heads: torch.ones(
        x.shape[0], heads, x.shape[1], device=x.device))
    code, res = run_small()
    assert code == 0 and not res["correct"]
    assert res["checks"]["embed_gap"]["value"] > res["checks"]["embed_gap"]["limit"]
