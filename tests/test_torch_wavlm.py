"""The WavLM embedding encoder (stutter_tpu_torch/models/wavlm.py) on the
CPU at a small size -- hidden 64, 4 heads, FFN 128, 2 layers, conv dims 32,
with the published kernels, strides, 128-tap / 16-group positional conv
and 320 / 800 buckets -- against the plain reference (tests/ref_wavlm.py),
which is held against transformers' WavLMModel.  The weights are the
reference's draw_params (every bias, LayerNorm, gate constant and weight
norm g away from its published constant, so a port that leaves one out
shows), with the gate's weights and the attention's biases at scale 1,
so the gated bias and the query's bias show in the output."""

import dataclasses
import filecmp
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ref_wavlm as R
from stutter_tpu_torch.config import EmbeddingFeatureConfig, PipelineConfig, WavLMConfig
from stutter_tpu_torch.models import wavlm as W
from stutter_tpu_torch.ops.frontend import (DEFAULT_BUCKETS, extract_features_numpy,
                                             fitted_groups, pad_to_bucket)
from stutter_tpu_torch.utils import profiling as P

REPO = Path(__file__).resolve().parent.parent
SMALL = WavLMConfig(conv_dim=(32,) * 7, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128, seed=3)
TOL = 2e-5  # max |got - ref| / (1 + |ref|) of a sound port (readings ~5e-7)
FAULT = 2e-4  # a planted fault must read above this: ten times TOL


def _params(cfg: WavLMConfig, device="cpu") -> dict:
    p = R.draw_params(dataclasses.asdict(cfg), cfg.seed, device)
    g = torch.Generator().manual_seed(cfg.seed + 1)
    for k in p:
        if "gru_rel_pos_linear" in k or ("_proj.bias" in k and "attention" in k):
            p[k] = torch.randn(p[k].shape, generator=g).to(device)
    return p


@pytest.fixture
def small():
    """SMALL's features config, its weights installed as the encoder's on
    the CPU; the encoders dropped afterwards."""
    p = _params(SMALL)
    W.release()
    W.encoder_for(SMALL).replicas[torch.device("cpu")] = p
    yield EmbeddingFeatureConfig(encoder=SMALL), p
    W.release()


def _clips(lengths=(9000, 24576, 30000, 50000, 12000, 170000, 60000, 401)):
    """Clips over every bucket, one longer than the largest (cut to it) and
    one of a single frame."""
    rng = np.random.RandomState(7)
    t = np.arange(max(lengths)) / 16000
    return [(0.1 * rng.randn(n) + 0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t[:n]))
            .astype(np.float32) for n in lengths]


def _gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(got - ref) / (1.0 + np.abs(ref))))


def _worst_gap(fc, p, clips, batch_size=3) -> float:
    X = extract_features_numpy(clips, fc, batch_size=batch_size, device="cpu")
    c = dataclasses.asdict(SMALL)
    assert X.shape == (len(clips), 69) and not X[:, 64:].any()
    return max(_gap(x[:64], R.embed(p, y[: DEFAULT_BUCKETS[-1]], c).numpy())
               for x, y in zip(X, clips))


def test_port_matches_the_reference_across_buckets(small):
    """extract_features_numpy over mixed lengths in every bucket (batches of
    3, so padded rows of other lengths): each clip's embedding is the
    reference's, the 5 text placeholders zero."""
    assert _worst_gap(*small, _clips()) < TOL


def test_embedding_is_the_same_alone_and_inside_a_padded_batch(small):
    """A clip's embedding does not depend on its batch or bucket: alone, in
    its own bucket, and padded to the largest bucket among longer clips."""
    fc, p = small
    clips = _clips((12000, 150000, 100000))
    alone = extract_features_numpy(clips[:1], fc, device="cpu")[0]
    fn = W.batch_fn_for(SMALL)
    N = DEFAULT_BUCKETS[-1]
    audio = torch.zeros(3, N)
    for i, y in enumerate(clips):
        audio[i, : len(y)] = torch.from_numpy(y)
    lengths = torch.tensor([len(y) for y in clips])
    with torch.no_grad():
        padded = fn(audio, lengths)[0].numpy()
    assert pad_to_bucket(len(clips[0])) != N
    np.testing.assert_allclose(padded, alone, rtol=0, atol=1e-5)


def test_a_batch_over_the_sample_budget_is_encoded_in_row_chunks(small, monkeypatch):
    """A batch of more samples than SAMPLE_BUDGET (extract_corpus's 256
    rows of the largest bucket) is encoded in row chunks, one encode call
    each, and gives what one call gives.  The batch is fitted to its
    longest clip, 24,000 samples (75 strides of 320), so 2 rows a call."""
    fc, _ = small
    clips = _clips((12000, 24000, 9000, 20000, 16000))
    whole = extract_features_numpy(clips, fc, batch_size=5, device="cpu")
    calls = []
    orig = W.encode
    monkeypatch.setattr(W, "SAMPLE_BUDGET", 2 * 24576)
    monkeypatch.setattr(W, "encode", lambda p, a, n, c: calls.append(a.shape) or orig(p, a, n, c))
    chunked = extract_features_numpy(clips, fc, batch_size=5, device="cpu")
    assert calls == [(2, 24000), (2, 24000), (1, 24000)]
    np.testing.assert_allclose(chunked, whole, rtol=0, atol=1e-5)


def _shifted(T, num_buckets, max_distance):
    return torch.clamp(_ORIG["relative_buckets"](T, num_buckets, max_distance) + 1,
                       max=num_buckets - 1)


def _layer_reading(edit):
    """encoder_layer as a port that reads layer i's weights as edit(p, i)
    gives them."""
    return lambda p, i, *a: _ORIG["encoder_layer"](edit(dict(p), i), i, *a)


def _q_bias_dropped(p, i):
    name = W.LAYER.format(i) + "attention.q_proj.bias"
    p[name] = torch.zeros_like(p[name])
    return p


def _norms_swapped(p, i):
    pre = W.LAYER.format(i)
    for leaf in ("weight", "bias"):
        a, b = f"{pre}layer_norm.{leaf}", f"{pre}final_layer_norm.{leaf}"
        p[a], p[b] = p[b], p[a]
    return p


def _weight_norm_left_out(p, h, cfg):
    """The positional conv with the weight v itself, g / |v| taken as 1."""
    v = p["encoder.pos_conv_embed.conv.weight_v"]
    return _ORIG["positional_conv"](
        dict(p, **{"encoder.pos_conv_embed.conv.weight_g": v.norm(dim=(0, 1), keepdim=True)}),
        h, cfg)


_ORIG = {"relative_buckets": W.relative_buckets, "encoder_layer": W.encoder_layer,
         "positional_conv": W.positional_conv}
FAULTS = {
    "bias_dropped": ("position_bias", lambda p, T, cfg, dev: torch.zeros(
        cfg.num_attention_heads, T, T, device=dev)),
    "gate_dropped": ("bias_gate", lambda p, i, x, heads: torch.ones(
        x.shape[0], heads, x.shape[1], device=x.device)),
    "buckets_shifted": ("relative_buckets", _shifted),
    "keys_unmasked": ("key_mask", lambda valid: torch.zeros(
        valid.shape[0], 1, 1, valid.shape[1], device=valid.device)),
    "q_bias_dropped": ("encoder_layer", _layer_reading(_q_bias_dropped)),
    "layer_norms_swapped": ("encoder_layer", _layer_reading(_norms_swapped)),
    "weight_norm_left_out": ("positional_conv", _weight_norm_left_out),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_against_the_reference(small, fault, monkeypatch):
    """The comparison sees each fault: the position bias dropped, its gate
    dropped, the buckets shifted by one, padded keys left unmasked, the
    query's bias dropped, a layer's two LayerNorms swapped, the positional
    conv's weight norm left out."""
    name, fn = FAULTS[fault]
    monkeypatch.setattr(W, name, fn)
    W._bucket_table.cache_clear()
    try:
        assert _worst_gap(*small, _clips()) > FAULT
    finally:
        W._bucket_table.cache_clear()


@pytest.mark.gpu
def test_tf32_fails_against_the_reference_on_the_card():
    """On the card, at the published widths and depth: the encoder's batch
    path at its own precision passes, and with TF32 on (its matmuls and
    convs in TF32) it fails the same comparison.  The batch goes to the
    batch_fn directly, since every entry point of the port turns TF32 off
    (device.resolve_device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: TF32 exists only there")
    from stutter_tpu_torch.device import resolve_device

    dev = resolve_device("cuda:0")
    wide = WavLMConfig(seed=3)
    p = R.draw_params(dataclasses.asdict(wide), wide.seed, dev)
    W.release()
    W.encoder_for(wide).replicas[dev] = p
    clips = [y[: DEFAULT_BUCKETS[-1]] for y in _clips()]
    c = dataclasses.asdict(wide)
    ref = [R.embed(p, y, c).cpu().numpy() for y in clips]
    audio = torch.zeros(len(clips), DEFAULT_BUCKETS[-1], device=dev)
    for i, y in enumerate(clips):
        audio[i, : len(y)] = torch.from_numpy(y)
    lengths = torch.tensor([len(y) for y in clips], device=dev)
    fn = W.batch_fn_for(wide)

    def worst():
        with torch.no_grad():
            X = fn(audio, lengths).cpu().numpy()
        return max(_gap(x[:1024], r) for x, r in zip(X, ref))

    try:
        sound = worst()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        low = worst()
        print(f"sound {sound:.3e} tf32 {low:.3e}")
        assert sound < TOL and low > FAULT
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        W.release()


def test_reference_matches_transformers_wavlm_model(monkeypatch):
    """The reference's last hidden state equals transformers.WavLMModel's
    (stable layer norm, an attention_mask over a padded pair) on the same
    weights, loaded by the checkpoint's names."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    pytest.importorskip("transformers")
    from transformers import WavLMConfig as HFConfig
    from transformers import WavLMModel

    c = dataclasses.asdict(SMALL)
    hf = HFConfig(**{k: list(v) if isinstance(v, tuple) else v for k, v in c.items()
                     if k not in ("seed", "weights")},
                  feat_extract_norm="layer", conv_bias=False, do_stable_layer_norm=True,
                  hidden_act="gelu", feat_extract_activation="gelu", mask_time_prob=0.0)
    model = WavLMModel(hf).eval()
    p = _params(SMALL)
    pos = "encoder.pos_conv_embed.conv."
    names = {pos + "weight_g": pos + "parametrizations.weight.original0",
             pos + "weight_v": pos + "parametrizations.weight.original1"}
    sd = model.state_dict()
    if pos + "weight_g" in sd:  # transformers without the parametrization
        names = {}
    missing, unexpected = model.load_state_dict({names.get(k, k): v for k, v in p.items()},
                                                strict=False)
    assert not unexpected and set(missing) <= {"masked_spec_embed"}
    clips = _clips((9000, 30000))
    audio = np.zeros((2, 30000), np.float32)
    mask = np.zeros((2, 30000), np.int64)
    for i, y in enumerate(clips):
        audio[i, : len(y)] = (y - y.mean()) / np.sqrt(y.var() + 1e-7)
        mask[i, : len(y)] = 1
    with torch.no_grad():
        out = model(torch.from_numpy(audio), attention_mask=torch.from_numpy(mask))
        for i, y in enumerate(clips):
            ref = R.hidden_states(p, torch.from_numpy(y), c)
            got = out.last_hidden_state[i, : R.n_frames(len(y), c)]
            assert ref.shape == got.shape
            assert float((got - ref).abs().max()) < 2e-5


def test_buckets_match_the_reference_over_every_distance():
    """relative_buckets, at the published 320 / 800, equals the reference's
    bucket table out past max_distance, both halves and the cap used."""
    a = W.relative_buckets(1200, 320, 800)
    b = R.buckets(1200, 320, 800)
    assert torch.equal(a, b)
    assert int(a.min()) == 0 and int(a.max()) == 319 and len(torch.unique(a)) > 300


def test_published_parameter_count_and_feature_width():
    """WavLM-Large's parameters reckoned from the shapes, nothing allocated:
    about 315.4 M (masked_spec_embed, a pre-training parameter, left out);
    its features are 1024 + 5 wide."""
    cfg = WavLMConfig()
    assert W.n_params(cfg) == 315_452_096
    assert W.frame_lengths(163840, cfg) == 511 and W.frame_lengths(399, cfg) == 0
    fc = EmbeddingFeatureConfig()
    assert fc.total_feature_len == 1029 and len(fc.feature_names()) == 1029


def test_the_two_reference_copies_are_byte_identical():
    assert filecmp.cmp(REPO / "tests" / "ref_wavlm.py",
                       REPO / "benchmark" / "reference" / "wavlm.py", shallow=False)


def test_weights_round_trip_through_persist_by_checkpoint_name(tmp_path):
    """save_wavlm / load_wavlm keep every parameter under its checkpoint
    name, bit for bit (the reference's names, drawn apart from the port's,
    are the port's); a config whose shapes differ is refused; a config
    naming the file runs the encoder on those weights."""
    from stutter_tpu_torch import persist

    p = _params(SMALL)
    path = tmp_path / "wavlm.npz"
    persist.save_wavlm(path, p)
    assert R.param_shapes(dataclasses.asdict(SMALL)) == W.param_shapes(SMALL)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(W.param_shapes(SMALL))
    back = persist.load_wavlm(path, SMALL, device="cpu")
    assert list(back) == list(W.param_shapes(SMALL))
    assert all(torch.equal(back[k], p[k]) for k in p)
    with pytest.raises(ValueError):
        persist.load_wavlm(path, dataclasses.replace(SMALL, num_hidden_layers=3), device="cpu")
    cfg = dataclasses.replace(SMALL, weights=str(path), seed=99)
    W.release()
    try:
        assert all(torch.equal(v, p[k]) for k, v in W.encoder_for(cfg).params("cpu").items())
    finally:
        W.release()


def test_without_a_checkpoint_the_weights_are_drawn_from_the_seed():
    """A config naming no weights draws them from its seed, under the
    checkpoint's names and shapes, at the published initial values: the
    same seed the same weights, another seed others; LayerNorms 1 and 0,
    the weight norm's g equal to |v|."""
    W.release()
    try:
        p = W.encoder_for(SMALL).params("cpu")
        assert {k: tuple(v.shape) for k, v in p.items()} == W.param_shapes(SMALL)
        again = W.init_params(SMALL, "cpu")
        other = W.init_params(SMALL, "cpu", seed=SMALL.seed + 1)
        q = W.LAYER.format(1) + "attention.q_proj.weight"
        assert all(torch.equal(p[k], again[k]) for k in p) and not torch.equal(p[q], other[q])
        ln = W.LAYER.format(0) + "final_layer_norm."
        assert bool((p[ln + "weight"] == 1).all()) and bool((p[ln + "bias"] == 0).all())
        pos = "encoder.pos_conv_embed.conv."
        torch.testing.assert_close(p[pos + "weight_g"],
                                   p[pos + "weight_v"].norm(dim=(0, 1), keepdim=True))
    finally:
        W.release()


def test_each_device_gets_one_copy_of_the_first_devices_weights(small):
    """The batch_fn's weights are chosen by the shard's device: the first
    device's are kept, every other device gets one copy of them (made once,
    then reused), the same names and shapes."""
    _, p = small
    enc = W.encoder_for(SMALL)
    meta = enc.params(torch.device("meta"))
    assert enc.params("meta") is meta and enc.params("cpu") is p
    assert list(meta) == list(p) and all(v.device.type == "meta" for v in meta.values())
    assert all(meta[k].shape == p[k].shape for k in p)


def test_predictor_runs_the_encoder_features(small):
    """Predictor over an EmbeddingFeatureConfig runs the encoder with no
    special case: its shape guard takes the rows (64 + 5 wide here), and
    the probabilities are the seeded MLP's over the reference's
    embedding."""
    from stutter_tpu_torch.infer import Predictor
    from stutter_tpu_torch.models.mlp import SeedMLP, init_mlp
    from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler

    fc, p = small
    seeds = [init_mlp(s, 69, (16, 8), 3) for s in range(3)]
    params = {k: np.stack([s[k] for s in seeds]) for k in seeds[0]}
    scaler = StandardScaler.from_arrays({"mean": np.zeros(69, np.float32),
                                         "scale": np.ones(69, np.float32)})
    pred = Predictor(scaler, LabelEncoder(classes_=["a", "b", "c"]),
                     SeedMLP.from_jax_params(params, device="cpu"), torch.device("cpu"),
                     PipelineConfig(features=fc), denoise_first=False)
    y = _clips((20000,))[0]
    got = pred.predict_clip(y)["proba"]
    emb = torch.cat([R.embed(p, y, dataclasses.asdict(SMALL)), torch.zeros(5)])
    ref = R.mlp_proba([torch.from_numpy(params[f"w{i}"]) for i in range(3)],
                      [torch.from_numpy(params[f"b{i}"]) for i in range(3)], emb).numpy()
    np.testing.assert_allclose([got[c] for c in "abc"], ref, atol=1e-5)


def test_traced_extraction_opens_the_wavlm_spans_and_counts_the_shapes(small, tmp_path):
    """Under a profiler, extract_features_numpy's encoder opens one
    `stp.wavlm.encode` a batch holding a `featenc`, a `pos_conv` and one
    `attention` a layer, and the counters add up to the batches' shapes
    (fitted_groups': the clips by length, each batch fitted to its longest):
    sum T_i and B T_pad frames, sum T_i^2 and B T_pad^2 attention pairs."""
    fc, _ = small
    clips = _clips((9000, 24576, 30000, 50000, 12000))
    before_c, before_s = P.counters(), len(P.spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        extract_features_numpy(clips, fc, batch_size=2, device="cpu")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("name", "").startswith("stp.wavlm.")]
    mem = P.spans()[before_s:]
    added = {k: v - before_c.get(k, 0) for k, v in P.counters().items()
             if k.startswith("wavlm.") and v != before_c.get(k, 0)}
    batches = [(N, [len(clips[i]) for i in idxs])
               for N, idxs in fitted_groups([len(y) for y in clips], 2, 320, DEFAULT_BUCKETS[-1])]
    T = {b: W.frame_lengths(b, SMALL) for b, _ in batches}
    t = [W.frame_lengths(n, SMALL) for y in clips for n in [len(y)]]
    assert added == {"wavlm.batches": len(batches),
                     "wavlm.valid_frames": sum(t),
                     "wavlm.sent_frames": sum(len(c) * T[b] for b, c in batches),
                     "wavlm.attn_pairs_valid": sum(x * x for x in t),
                     "wavlm.attn_pairs_sent": sum(len(c) * T[b] ** 2 for b, c in batches)}
    for source in (names, ["stp." + s.name for s in mem if s.name.startswith("wavlm.")]):
        assert source.count("stp.wavlm.encode") == len(batches)
        assert source.count("stp.wavlm.featenc") == source.count("stp.wavlm.pos_conv") == len(batches)
        assert source.count("stp.wavlm.attention") == len(batches) * SMALL.num_hidden_layers
    enc = [s for s in mem if s.name == "wavlm.encode"]
    inner = [s for s in mem if s.name in ("wavlm.featenc", "wavlm.pos_conv", "wavlm.attention")]
    assert all(any(e.start_ns <= s.start_ns and s.end_ns <= e.end_ns for e in enc) for s in inner)
    assert os.path.getsize(path) > 0


def test_fitted_batches_give_each_clip_alone_and_the_buckets_rows(small):
    """run_bucketed with the encoder's batch_fn (which carries its stride,
    320 samples) over 20 clips of mixed lengths, one past the largest
    bucket and one too short to give a frame, in batches of 4: every batch
    is fitted to its longest clip (fitted_groups' batches, each counted
    under a profiler), and each clip's row is encode of that clip alone,
    unpadded and cut to the cap, and the row the DEFAULT_BUCKETS batches
    give."""
    from stutter_tpu_torch.ops.frontend import run_bucketed

    fc, p = small
    rng = np.random.RandomState(3)
    lengths = [170000, 300, *rng.randint(1000, 160000, 18)]
    clips = _clips(tuple(int(n) for n in lengths))
    fn = W.batch_fn_for(SMALL)
    assert fn.frame_stride == 320
    before = P.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        fitted = run_bucketed(clips, fn, 69, batch_size=4, device="cpu")
    added = {k: v - before.get(k, 0) for k, v in P.counters().items()}
    assert added["run_bucketed.batches"] == len(
        fitted_groups(lengths, 4, 320, DEFAULT_BUCKETS[-1])) == 5
    assert added["run_bucketed.pad_samples"] == 4 * sum(
        N for N, _ in fitted_groups(lengths, 4, 320, DEFAULT_BUCKETS[-1]))
    bucketed = run_bucketed(clips, lambda a, n: fn(a, n), 69, batch_size=4, device="cpu")
    cap = DEFAULT_BUCKETS[-1]
    with torch.no_grad():
        alone = [W.encode(p, torch.from_numpy(y[:cap])[None], torch.tensor([len(y[:cap])]),
                          SMALL)[0].numpy() for y in clips]
    assert not alone[1].any() and not fitted[1].any()
    assert max(_gap(x[:64], a) for x, a in zip(fitted, alone)) < TOL
    assert max(_gap(x, b) for x, b in zip(fitted, bucketed)) < TOL


@pytest.mark.parametrize("T", [1, 2, 45, 311, 511])
def test_position_bias_is_a_corner_of_one_table(T):
    """position_bias slices the [:T, :T] corner of one bucket table a
    device, built at the frames of the longest clip (511), and equals the
    bias gathered from relative_buckets(T)."""
    p = _params(SMALL)
    emb = p[W.LAYER.format(0) + "attention.rel_attn_embed.weight"]
    W._bucket_table.cache_clear()
    try:
        got = W.position_bias(p, T, SMALL, "cpu")
        W.position_bias(p, 45, SMALL, "cpu")
        assert W._bucket_table.cache_info().currsize == 1
        table = W._bucket_table(W.frame_lengths(W.LONGEST, SMALL), SMALL.num_buckets,
                                SMALL.max_bucket_distance, torch.device("cpu"))
        assert table.shape == (511, 511)
        want = W.relative_buckets(T, SMALL.num_buckets, SMALL.max_bucket_distance)
        assert torch.equal(table[:T, :T], want)
        assert torch.equal(got, emb[want].permute(2, 0, 1))
    finally:
        W._bucket_table.cache_clear()
