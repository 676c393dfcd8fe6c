"""The Parakeet cell's yardstick and check on the CPU at a small size: the
counts of counts/parakeet.py against a hand count and the long-form mix,
the port's own counters against the counts' frames and pairs, the two
copies of the reference, and a whole run of parakeet_ctc_1.1b.longform
(the look for a chip skipped, recordings of 11-20 s) that is correct when
sound, and not when the positional term is dropped or its sign flipped,
BatchNorm ignored, the gate's threshold off, or the recordings cut at the
largest bucket."""

import filecmp
import json
from pathlib import Path

import numpy as np
import pytest

import run
from counts import parakeet as C
from counts.work import bound_s, fft_ops

BENCH = Path(__file__).resolve().parent.parent
CONFIGS = BENCH / "configs"
# the whole-run checks' widths: the published head width of 128
RUN_SMALL = {"hidden_size": 256, "num_hidden_layers": 2, "num_attention_heads": 2,
             "intermediate_size": 512, "subsampling_conv_channels": 32}
SMALL = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
         "intermediate_size": 96, "subsampling_conv_channels": 8}


def encoder(**over) -> dict:
    return {**json.loads((CONFIGS / "parakeet_ctc_1.1b.json").read_text())["encoder"], **over}


def test_counts_of_one_clip_by_hand():
    """One 2 s clip at the small widths: 32,000 samples give 200 log-mel
    frames and 25 encoder frames (100, 50, 25); every stage by hand."""
    enc = encoder(**SMALL)
    assert C.mel_frames(32000) == 200 and C.n_frames(32000) == 25
    assert C.n_frames(159) == 0 and C.n_frames(160) == 1 and C.n_frames(1280) == 1
    assert C.n_frames(1440) == 2
    s = C.encoder_stages(32000, enc)
    T, Fr, d, f, h, L, Ch = 25, 200, 64, 96, 2, 2, 8
    assert s["fbank"] == (3 * 32000 + Fr * (512 + fft_ops(512) + 3 * 257 + 2 * 257 * 80 + 8 * 80),
                          4 * (32000 + Fr * 80))
    stem = ((18 + 3) * Ch * 100 * 40 + (18 + 2) * Ch * 50 * 20 + (2 * Ch + 3) * Ch * 50 * 20
            + (18 + 2) * Ch * 25 * 10 + (2 * Ch + 3) * Ch * 25 * 10 + 2 * T * Ch * 10 * d + 2 * T * d)
    assert s["stem"] == (stem, 4 * (Fr * 80 + 2 * Ch * 100 * 40 + 4 * Ch * 50 * 20
                                    + 4 * Ch * 25 * 10 + T * d))
    assert s["ffn"] == (2 * L * (7 * T * d + 4 * T * d * f + T * f + 4 * T * f + 3 * T * d),
                        2 * L * 4 * (3 * T * d + 2 * T * f))
    assert s["layers"] == (L * (7 * T * d + 8 * T * d * d + 4 * T * d + 2 * T * d), L * 4 * 10 * T * d)
    assert s["position"] == (L * 2 * (2 * T - 1) * d * d, L * 4 * 2 * (2 * T - 1) * d)
    attn = T * 2 * d + h * T * T * 8 + 6 * T * T * d
    assert s["attention"] == (L * attn, L * 4 * (4 * T * d + (2 * T - 1) * d))
    assert s["conv_norm"] == (L * 7 * T * d, L * 4 * 2 * T * d)
    assert s["conv_pointwise1"] == (L * (4 * T * d * d + 2 * T * d), L * 4 * 3 * T * d)
    assert s["conv_glu"] == (L * 4 * T * d, L * 4 * 3 * T * d)
    assert s["conv_depthwise"] == (L * (2 * 9 + 3) * T * d, L * 4 * 2 * T * d)
    assert s["conv_silu"] == (L * 4 * T * d, L * 4 * 2 * T * d)
    assert s["conv_pointwise2"] == (L * (2 * T * d * d + T * d), L * 4 * 2 * T * d)
    assert s["final"] == (L * 7 * T * d + T * d, 4 * (L * 2 * T * d + T * d + d))
    assert C.pairs([32000, 159, 32000]) == (50, 2 * 25 * 25)
    assert C.encoder_work([159], enc) == {}
    assert C.attention_bound_s([32000], enc) == bound_s(*s["attention"])
    assert C.conv_module_bound_s([32000], enc) == sum(bound_s(*s[k]) for k in C.CONV_STAGES)


def test_the_longform_mix_and_its_work():
    """longform_32's 32 recordings: 2,630 s of audio, 20.9-148.5 s, median
    79.7 s; at the published widths 32,890 encoder frames and 3.94e7
    pairs; about 66.7 TFLOP of row-wise GEMMs, 10.3 of attention and 5.8 of
    per-recording positional projections a pass; four fitted batches of 8
    at 57.5, 78.2, 105.4 and 148.5 s."""
    import gen

    from stutter_tpu_torch.ops.frontend import fitted_groups

    mix = json.loads((BENCH / "mixes" / "longform_32.json").read_text())
    assert mix["kind"] == "embed_pass_parakeet" and mix["clips"] == 32
    d = gen.lengths_s(mix["clips"], mix["lengths"])
    assert 2625 < d.sum() < 2635 and 20.8 < d.min() < 21 and 148 < d.max() < 149
    assert 79 < float(np.median(d)) < 80.5
    n = [int(x * 16000) for x in d]
    assert C.pairs(n) == (32890, 39374368)
    w = C.encoder_work(n, encoder())
    gemm = sum(w[k][0] for k in ("ffn", "layers", "conv_pointwise1", "conv_pointwise2"))
    assert 66e12 < gemm < 67.5e12
    assert 10.0e12 < w["attention"][0] < 10.5e12
    assert 5.7e12 < w["position"][0] < 5.9e12
    groups = fitted_groups(n, 8, 1280, 6_400_000)
    assert [len(i) for _, i in groups] == [8] * 4
    assert [round(N / 16000, 1) for N, _ in groups] == [57.5, 78.2, 105.4, 148.5]


def test_the_two_reference_copies_are_byte_identical():
    assert filecmp.cmp(BENCH.parent / "tests" / "ref_parakeet.py", BENCH / "reference" / "parakeet.py",
                       shallow=False)


def test_the_ports_counters_equal_the_counts():
    """A traced extraction at the small widths counts the frames and pairs
    counts/parakeet.py reckons from the recordings' lengths."""
    from torch.profiler import ProfilerActivity, profile

    from stutter_tpu_torch.config import EmbeddingFeatureConfig, ParakeetConfig
    from stutter_tpu_torch.models import parakeet
    from stutter_tpu_torch.ops.frontend import extract_features_numpy
    from stutter_tpu_torch.utils import profiling

    enc = encoder(**SMALL)
    cfg = ParakeetConfig(**{k: v for k, v in enc.items() if k in ParakeetConfig.__dataclass_fields__})
    rng = np.random.RandomState(3)
    clips = [rng.randn(n).astype(np.float32) for n in (8000, 30000, 200000, 100, 120000)]
    before = profiling.counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            extract_features_numpy(clips, EmbeddingFeatureConfig(encoder=cfg), batch_size=2,
                                   device="cpu")
    finally:
        parakeet.release()
    got = {k: v - before.get(k, 0) for k, v in profiling.counters().items()}
    assert (got["parakeet.valid_frames"], got["parakeet.attn_pairs_valid"]) == C.pairs(
        [len(y) for y in clips])
    assert got["parakeet.sent_frames"] == got["parakeet.valid_frames"]
    assert got.get("run_bucketed.cut_samples", 0) == 0


def sharp_attention(draw_params):
    """draw_params with the attention's projections at std 0.3, not 0.02:
    at two blocks of 256 the published scale leaves the positional term
    too faint to show at the cell's limits (at 42 blocks of 1024 a dropped
    term reads over 5e-2 there)."""
    def draw(cfg, seed, device="cpu"):
        p = draw_params(cfg, seed, device)
        for k in p:
            if "self_attn." in k and k.endswith("_proj.weight"):
                p[k] = p[k] * 15.0
        return p

    return draw


def run_small(seed: int = 2**31 + 41):
    from reference import parakeet as ref

    orig = ref.draw_params
    ref.draw_params = sharp_attention(orig)
    try:
        return _run_small(seed)
    finally:
        ref.draw_params = orig


def _run_small(seed: int):
    ctx = run.Ctx("parakeet_ctc_1.1b.longform", seed, 1.0, False, "cpu",
                  overrides={"clips": 3, "check_clips": 2,
                             "lengths": {"median_s": 13.0, "sigma": 0.3, "min_s": 10.5,
                                         "max_s": 20.0, "shape_seed": 20262}})
    ctx.config["encoder"].update(RUN_SMALL)
    ctx.config["feature_dim"] = RUN_SMALL["hidden_size"] + 5
    ctx.config["mlp"]["dims"][0] = RUN_SMALL["hidden_size"] + 5
    return run.run(ctx, require_chip=False)


def test_a_sound_run_is_correct():
    """Recordings past the largest bucket reach the gate and the encoder
    whole: the run is correct and cut_samples reads 0."""
    code, res = run_small()
    assert code == 0 and res["correct"] and res["failed"] == 0
    assert set(res["checks"]) == {"embed_gap", "proba_gap", "gate_gap", "cut_samples"}
    assert res["checks"]["cut_samples"]["value"] == 0
    assert set(res["metrics"]) == {"clips_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["positional term dropped", "sign of i - j flipped",
                                   "BatchNorm ignored"])
def test_a_run_with_an_encoder_fault_is_not_correct(fault, monkeypatch):
    """A fault planted in the program's encoder fails the embedding's
    check."""
    from stutter_tpu_torch.models import parakeet

    sinusoids = parakeet.sinusoids

    def bn_ignored(p, cfg):
        for i in range(cfg.num_hidden_layers):
            pre = parakeet.LAYER.format(i)
            p[pre + parakeet.FOLDED + "weight"] = p[pre + "conv.depthwise_conv.weight"][:, 0].contiguous()
            p[pre + parakeet.FOLDED + "bias"] = p[pre + "conv.depthwise_conv.bias"]
        return p

    swap = {"positional term dropped": ("sinusoids", lambda T, D, dev: 0 * sinusoids(T, D, dev)),
            "sign of i - j flipped": ("sinusoids", lambda T, D, dev: sinusoids(T, D, dev).flip(0)),
            "BatchNorm ignored": ("fold_batchnorm", bn_ignored)}[fault]
    monkeypatch.setattr(parakeet, *swap)
    code, res = run_small()
    assert code == 0 and not res["correct"]
    assert res["checks"]["embed_gap"]["value"] > res["checks"]["embed_gap"]["limit"]


def test_a_run_with_the_gates_threshold_off_is_not_correct(monkeypatch):
    """The program's gate with its threshold moved by 1 %: gate_gap fails,
    the encoder's gaps stay within their limits."""
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


def test_a_run_that_cuts_at_the_largest_bucket_is_not_correct(monkeypatch):
    """An encoder batch_fn with no max_samples (run_bucketed then cuts at
    the largest bucket, 10.24 s, as before long recordings were kept
    whole): cut_samples counts the dropped samples and the run fails."""
    from stutter_tpu_torch.models import parakeet

    orig = parakeet.batch_fn_for

    def cutting(cfg, text_len=5):
        fn = orig(cfg, text_len)
        del fn.max_samples
        return fn

    monkeypatch.setattr(parakeet, "batch_fn_for", cutting)
    code, res = run_small()
    assert code == 0 and not res["correct"]
    assert res["checks"]["cut_samples"]["value"] > 0
