"""The W2V-BERT 2.0 embedding encoder (stutter_tpu_torch/models/w2v_bert.py
and its fbank, ops/fbank.py) on the CPU at a small size -- hidden 64, 2
layers, 4 heads of 16, FFN 128, with the published 31-tap depthwise conv
and 64 / 8 distances -- against the plain reference (tests/ref_w2v_bert.py),
which is held against transformers' SeamlessM4TFeatureExtractor and
Wav2Vec2BertModel.  The weights are the reference's draw_params (every
bias and LayerNorm away from its published constant, so a port that
leaves one out shows), with the attention's projections at scale 0.3 so
the relative-key term shows in the output."""

import dataclasses
import filecmp
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ref_w2v_bert as R
from stutter_tpu_torch.config import (FEATURES_W2V_BERT, EmbeddingFeatureConfig, PipelineConfig,
                                      W2VBertConfig)
from stutter_tpu_torch.models import w2v_bert as W
from stutter_tpu_torch.ops import fbank as FB
from stutter_tpu_torch.ops.frontend import DEFAULT_BUCKETS, extract_features_numpy, fitted_groups
from stutter_tpu_torch.utils import profiling as P

REPO = Path(__file__).resolve().parent.parent
SMALL = W2VBertConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=128, seed=3)
TOL = 2e-5  # max |got - ref| / (1 + |ref|) of a sound port (readings ~2e-6)
FAULT = 2e-4  # a planted fault must read above this: ten times TOL
# on the card at the published widths: 24 FP32 layers of 1024, batched
# against one clip (readings 2.0e-5; TF32 3.5e-3)
CARD_TOL = 1e-4


def _params(cfg: W2VBertConfig, device="cpu") -> dict:
    p = R.draw_params(dataclasses.asdict(cfg), cfg.seed, device)
    g = torch.Generator().manual_seed(cfg.seed + 1)
    for k in p:
        if "self_attn.linear_" in k and k.endswith("weight"):
            p[k] = (0.3 * torch.randn(p[k].shape, generator=g)).to(device)
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


def _clips(lengths=(9000, 24576, 30000, 50000, 12000, 170000, 60000, 401, 1200)):
    """Clips over every bucket, one longer than the largest (cut to it), one
    of a single fbank frame and one of 6 (3 encoder frames)."""
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
    worst = 0.0
    for x, y in zip(X, clips):
        y = y[: DEFAULT_BUCKETS[-1]]
        if R.n_frames(len(y)) == 0:
            assert not x.any()
            continue
        worst = max(worst, _gap(x[:64], R.embed(p, y, c).numpy()))
    return worst


def test_port_matches_the_reference_across_fitted_batches(small):
    """extract_features_numpy over mixed lengths (fitted batches of 3, so
    padded rows of other lengths): each clip's embedding is the
    reference's, a clip of under one frame pair zero, the 5 text
    placeholders zero."""
    assert _worst_gap(*small, _clips()) < TOL


def test_embedding_is_the_same_alone_and_inside_a_padded_batch(small):
    """A clip's embedding does not depend on its batch: alone, and padded
    to the largest bucket among longer clips."""
    fc, _ = small
    clips = _clips((12000, 150000, 100000))
    alone = extract_features_numpy(clips[:1], fc, device="cpu")[0]
    fn = W.batch_fn_for(SMALL)
    N = DEFAULT_BUCKETS[-1]
    audio = torch.zeros(3, N)
    for i, y in enumerate(clips):
        audio[i, : len(y)] = torch.from_numpy(y)
    with torch.no_grad():
        padded = fn(audio, torch.tensor([len(y) for y in clips]))[0].numpy()
    np.testing.assert_allclose(padded, alone, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [400, 559, 560, 799, 800, 959, 8000, 16399, 163840])
def test_fbank_of_a_clip_alone_and_in_a_batch_is_the_references(n):
    """ops/fbank.features of a clip alone and as the short row of a padded
    batch (beside a longer clip, the padding nonzero past the clip) equal
    the reference's fbank over its own frames; frame_lengths is
    (1 + (n - 400) // 160) // 2."""
    y = _clips((n,))[0]
    other = _clips((n + 3333,))[0]
    assert FB.frame_lengths(n) == R.n_frames(n) == (1 + (n - 400) // 160) // 2
    ref = R.fbank(torch.from_numpy(y)) if R.n_frames(n) else torch.zeros(0, 160)
    audio = torch.from_numpy(np.stack([np.pad(y, (0, len(other) - n), constant_values=0.5),
                                       other]))
    feats, t = FB.features(audio, torch.tensor([n, len(other)]))
    alone, t1 = FB.features(torch.from_numpy(y)[None], torch.tensor([n]))
    assert int(t[0]) == int(t1[0]) == ref.shape[0]
    assert alone.shape == (1, ref.shape[0], 160)
    for got in (feats[0, : ref.shape[0]], alone[0]):
        assert not ref.numel() or float((got - ref).abs().max()) < 2e-4


def test_frame_lengths_below_one_frame_are_zero():
    assert FB.frame_lengths(0) == FB.frame_lengths(399) == FB.frame_lengths(559) == 0
    assert FB.frame_lengths(560) == 1
    n = torch.tensor([0, 399, 400, 560, 163840])
    assert FB.frame_lengths(n).tolist() == [0, 0, 0, 1, 511]


def test_a_batch_over_the_sample_budget_is_encoded_in_row_chunks(small, monkeypatch):
    """A batch of more samples than SAMPLE_BUDGET is encoded in row chunks,
    one encode call each, and gives what one call gives."""
    from stutter_tpu_torch.models import wavlm

    fc, _ = small
    clips = _clips((12000, 24000, 9000, 20000, 16000))
    whole = extract_features_numpy(clips, fc, batch_size=5, device="cpu")
    calls = []
    orig = W.encode
    monkeypatch.setattr(wavlm, "SAMPLE_BUDGET", 2 * 24576)
    monkeypatch.setattr(W, "encode", lambda p, a, n, c: calls.append(a.shape) or orig(p, a, n, c))
    chunked = extract_features_numpy(clips, fc, batch_size=5, device="cpu")
    assert calls == [(2, 24000), (2, 24000), (1, 24000)]
    np.testing.assert_allclose(chunked, whole, rtol=0, atol=1e-5)


# ------------------------------------------------------------ packed rows

def _encode(p, clips, N=None):
    """W.encode of `clips` zero-padded to N samples (their longest by
    default) -> [B, 64] numpy."""
    N = N or max(len(y) for y in clips)
    audio = torch.zeros(len(clips), N)
    for i, y in enumerate(clips):
        audio[i, : len(y)] = torch.from_numpy(y)
    with torch.no_grad():
        return W.encode(p, audio, torch.tensor([len(y) for y in clips]), SMALL).numpy()


def test_packed_encode_matches_the_reference_on_a_ragged_batch():
    """encode on one ragged batch (frames 1 to 93, packed to their sum):
    each clip's embedding within TOL of the reference's on the clip alone,
    unpadded."""
    p = _params(SMALL)
    clips = _clips((30000, 800, 9000, 16399, 24576, 5000))
    got = _encode(p, clips)
    c = dataclasses.asdict(SMALL)
    assert max(_gap(x, R.embed(p, y, c).numpy()) for x, y in zip(got, clips)) < TOL


def test_a_clip_alone_equals_itself_inside_a_packed_batch():
    """Each clip's embedding from encode of it alone and from encode of a
    packed batch of five (clips before and after it, the batch padded past
    its longest) agree to 1e-5."""
    p = _params(SMALL)
    clips = _clips((12000, 40000, 3000, 26000, 9000))
    batch = _encode(p, clips, N=50000)
    for x, y in zip(batch, clips):
        np.testing.assert_allclose(x, _encode(p, [y])[0], rtol=0, atol=1e-5)


def test_a_clip_of_no_frame_gives_a_zero_embedding():
    """A clip under one frame pair has no row: its embedding is zero, beside
    and between clips that have rows (theirs as alone), and a batch whose
    clips have no row at all gives zeros."""
    p = _params(SMALL)
    clips = _clips((300, 20000, 559, 9000, 0))
    got = _encode(p, clips)
    assert not got[[0, 2, 4]].any()
    for i in (1, 3):
        np.testing.assert_allclose(got[i], _encode(p, [clips[i]])[0], rtol=0, atol=1e-5)
    none = _encode(p, clips[:1] + clips[2:3], N=4000)
    assert none.shape == (2, 64) and not none.any()


@pytest.mark.parametrize("frames", [[1, 30, 31, 45, 440], [440, 0, 1], [2, 2, 2], [29, 31, 30]])
def test_plain_packed_depthwise_conv_equals_conv1d_on_each_clip_alone(frames):
    """depthwise_conv on packed rows, and glu_depthwise_plain (GLU first),
    equal F.conv1d with a left pad of K - 1 on each clip padded alone:
    clips of 1, 30 and 31 frames (under, at and past the 30-row halo),
    one of none, one of 440."""
    g = torch.Generator().manual_seed(sum(frames))
    C, K = 64, W.CONV_TAPS
    w = torch.randn(C, 1, K, generator=g)
    x = torch.randn(sum(frames), 2 * C, generator=g)
    clips = W.pack_clips(frames, "cpu")
    glu = torch.nn.functional.glu(x, dim=-1)
    got, fused = W.depthwise_conv(glu, w, clips), W.glu_depthwise_plain(x, w, clips)
    s = 0
    for n in (n for n in frames if n):
        seg = torch.nn.functional.pad(glu[s : s + n].T[None], (K - 1, 0))
        want = torch.nn.functional.conv1d(seg, w, groups=C)[0].T
        for y in (got, fused):
            assert float((y[s : s + n] - want).abs().max()) < 1e-5
        s += n
    assert got.shape == fused.shape == (s, C)


def test_pack_index_and_offsets_lay_out_each_clips_rows():
    """pack_index puts clip b's rows t < frames[b] at b T + t, clip after
    clip; pack_clips' offsets are the running sums; row_starts gives each
    row its clip's first row."""
    f = torch.tensor([3, 0, 2, 1])
    assert W.pack_index(f, 4).tolist() == [0, 1, 2, 8, 9, 12]
    clips = W.pack_clips(f, "cpu")
    assert clips.offsets.dtype == torch.int32 and clips.offsets.tolist() == [0, 3, 3, 5, 6]
    assert clips.longest == 3 and W.pack_clips([], "cpu").longest == 0
    assert W.row_starts(clips, "cpu").tolist() == [0, 0, 0, 3, 3, 5]
    assert W.attn_pairs_run([0, 5]) == W.attn_pairs_run([5]) == 16 * 8


# ------------------------------------------------------------ planted faults

_ORIG = {"distance_index": W.distance_index, "depthwise_conv": W.depthwise_conv,
         "conv_module": W.conv_module, "feed_forward": W.feed_forward,
         "normalise": FB.normalise, "stack_pairs": FB.stack_pairs}


def _centred(x, w, clips):
    """The depthwise conv centred on each row, over each clip's rows alone."""
    K = w.shape[-1]
    out, s = [], 0
    for n in (n for n in clips.frames.tolist() if n):
        seg = x[s : s + n].T[None]
        out.append(torch.nn.functional.conv1d(seg, w, padding=K // 2, groups=w.shape[0])[0].T)
        s += n
    return torch.cat(out) if out else x


def _across_clips(x, w, clips):
    """The causal depthwise conv over the packed rows as one sequence: a
    clip's first rows read up to K - 1 rows of the clip before it."""
    K = w.shape[-1]
    return torch.nn.functional.conv1d(torch.nn.functional.pad(x.T[None], (K - 1, 0)), w,
                                      groups=w.shape[0])[0].T


def _ffn1_whole(p, name, x):
    out = _ORIG["feed_forward"](p, name, x)
    return 2.0 * out if name.endswith("ffn1") else out


def _pairs_swapped(feats):
    B, n, m = feats.shape
    T = n // 2
    return feats[:, : 2 * T].reshape(B, T, 2, m).flip(2).reshape(B, T, 2 * m)


FAULTS = {
    "relkey_bias_dropped": (W, "rel_key_scores", lambda q, d, idx: torch.zeros(
        *q.shape[:2], *idx.shape)),
    "clamp_swapped": (W, "distance_index", lambda T, left, right, device=None:
                      _ORIG["distance_index"](T, right, left, device)),
    "depthwise_centred": (W, "depthwise_conv", _centred),
    "depthwise_reads_the_clip_before": (W, "depthwise_conv", _across_clips),
    "ffn_half_dropped": (W, "feed_forward", _ffn1_whole),
    "fbank_normalised_over_padding": (FB, "normalise", lambda feats, n: _ORIG["normalise"](
        feats, torch.full_like(n, feats.shape[1]))),
    "pairs_swapped": (FB, "stack_pairs", _pairs_swapped),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_against_the_reference(small, fault, monkeypatch):
    """The comparison sees each fault: the relative-key term dropped, the
    distance clamp swapped to [-8, 64], the depthwise conv centred instead
    of causal, the causal conv reading up to 30 rows of the clip packed
    before, FFN1's 1/2 dropped, the fbank normalised over the padded
    frames, each frame pair stacked in the wrong order."""
    module, name, fn = FAULTS[fault]
    monkeypatch.setattr(module, name, fn)
    assert _worst_gap(*small, _clips()) > FAULT


def test_padded_frames_unzeroed_before_the_conv_module_fail_against_transformers(small,
                                                                                  monkeypatch):
    """The conv module on packed rows against transformers'
    Wav2Vec2BertConvolutionModule over a padded batch with its attention
    mask (which zeroes the padded frames before the depthwise conv): each
    clip's rows are the module's at that clip's frames.  Packed, the rows
    before a clip's first are the clip before it, where the padded batch
    had zeros; a depthwise conv that reads them, planted, fails against the
    module in every clip but the first."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    pytest.importorskip("transformers")
    from transformers import Wav2Vec2BertConfig
    from transformers.models.wav2vec2_bert.modeling_wav2vec2_bert import (
        Wav2Vec2BertConvolutionModule)

    fc, p = small
    c = dataclasses.asdict(SMALL)
    hf = Wav2Vec2BertConfig(**{k: v for k, v in c.items() if k not in ("seed", "weights")})
    mod = Wav2Vec2BertConvolutionModule(hf).eval()
    pre = W.LAYER.format(1) + "conv_module."
    mod.load_state_dict({k[len(pre):]: v for k, v in p.items() if k.startswith(pre)})
    g = torch.Generator().manual_seed(5)
    h = torch.randn(3, 50, 64, generator=g)
    frames = torch.tensor([50, 17, 40])
    valid = W._valid(frames, 50)
    clips = W.pack_clips(frames, "cpu")
    packed = h[valid]
    with torch.no_grad():
        want = mod(h, attention_mask=valid.long())[valid]
        sound = W.conv_module(p, 1, packed, clips, SMALL)
        monkeypatch.setattr(W, "depthwise_conv", _across_clips)
        planted = W.conv_module(p, 1, packed, clips, SMALL)
    assert float((sound - want).abs().max()) < 1e-5
    assert float((planted[:50] - want[:50]).abs().max()) < 1e-5  # the first clip has none before
    for s, n in ((50, 17), (67, 40)):
        assert float((planted[s : s + n] - want[s : s + n]).abs().max()) > FAULT
    assert _worst_gap(fc, p, _clips()) > FAULT


# ------------------------------------------------------------ transformers

def test_reference_matches_transformers(monkeypatch):
    """The reference's fbank is SeamlessM4TFeatureExtractor's (which works
    in float64; the FP32 spectrum's low bins differ by up to ~2e-4), and
    its last hidden state, on the extractor's own features, is
    transformers.Wav2Vec2BertModel's over a padded batch with its
    attention_mask, on the same weights loaded by the checkpoint's names."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    pytest.importorskip("transformers")
    from transformers import SeamlessM4TFeatureExtractor, Wav2Vec2BertConfig, Wav2Vec2BertModel

    c = dataclasses.asdict(SMALL)
    hf = Wav2Vec2BertConfig(**{k: v for k, v in c.items() if k not in ("seed", "weights")},
                            mask_time_prob=0.0)
    model = Wav2Vec2BertModel(hf).eval()
    p = _params(SMALL)
    missing, unexpected = model.load_state_dict(p, strict=False)
    assert not missing and not unexpected
    clips = _clips((9000, 30000, 16399))
    inp = SeamlessM4TFeatureExtractor()(clips, sampling_rate=16000, return_tensors="pt")
    with torch.no_grad():
        out = model(inp["input_features"], attention_mask=inp["attention_mask"])
    for i, y in enumerate(clips):
        feats = R.fbank(torch.from_numpy(y))
        T = feats.shape[0]
        assert T == R.n_frames(len(y)) == int(inp["attention_mask"][i].sum())
        assert float((inp["input_features"][i, :T] - feats).abs().max()) < 1e-3
        ref = R.hidden_states(p, inp["input_features"][i, :T], c)
        assert float((out.last_hidden_state[i, :T] - ref).abs().max()) < 2e-5


def test_published_parameter_count_and_feature_width(monkeypatch):
    """W2V-BERT 2.0's parameters reckoned from the shapes, nothing
    allocated: 580,492,096 (masked_spec_embed, a pre-training parameter,
    left out), transformers' model on the meta device name for name and
    shape; its features are 1024 + 5 wide."""
    cfg = W2VBertConfig()
    assert W.n_params(cfg) == 580_492_096
    assert R.param_shapes(dataclasses.asdict(cfg)) == W.param_shapes(cfg)
    assert FEATURES_W2V_BERT.total_feature_len == 1029
    assert len(FEATURES_W2V_BERT.feature_names()) == 1029
    assert FEATURES_W2V_BERT.audio_feature_len == 1024
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    pytest.importorskip("transformers")
    from transformers import Wav2Vec2BertConfig, Wav2Vec2BertModel

    with torch.device("meta"):
        model = Wav2Vec2BertModel(Wav2Vec2BertConfig())
    got = {k: tuple(v.shape) for k, v in model.state_dict().items() if k != "masked_spec_embed"}
    assert got == W.param_shapes(cfg)


def test_the_two_reference_copies_are_byte_identical():
    assert filecmp.cmp(REPO / "tests" / "ref_w2v_bert.py",
                       REPO / "benchmark" / "reference" / "w2v_bert.py", shallow=False)


# ------------------------------------------------------------ weights

def test_weights_round_trip_through_persist_by_checkpoint_name(tmp_path):
    """save_wavlm / load_wavlm keep every parameter under its
    checkpoint name, bit for bit; a config whose shapes differ is refused;
    a config naming the file runs the encoder on those weights."""
    from stutter_tpu_torch import persist

    p = _params(SMALL)
    path = tmp_path / "w2v.npz"
    persist.save_wavlm(path, p)
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
    biases 0, the convs Kaiming-normal."""
    W.release()
    try:
        p = W.encoder_for(SMALL).params("cpu")
        assert {k: tuple(v.shape) for k, v in p.items()} == W.param_shapes(SMALL)
        again = W.init_params(SMALL, "cpu")
        other = W.init_params(SMALL, "cpu", seed=SMALL.seed + 1)
        q = W.LAYER.format(1) + "self_attn.linear_q.weight"
        assert all(torch.equal(p[k], again[k]) for k in p) and not torch.equal(p[q], other[q])
        ln = W.LAYER.format(0) + "conv_module.depthwise_layer_norm."
        assert bool((p[ln + "weight"] == 1).all()) and bool((p[ln + "bias"] == 0).all())
        assert not p[W.LAYER.format(0) + "ffn2.output_dense.bias"].any()
        dw = p[W.LAYER.format(0) + "conv_module.depthwise_conv.weight"]
        assert abs(float(dw.std()) - math.sqrt(2 / 31)) < 0.05
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
    """Predictor over an EmbeddingFeatureConfig with a W2VBertConfig runs
    the encoder with no special case; the probabilities are the seeded
    MLP's over the reference's embedding."""
    from stutter_tpu_torch.infer import Predictor
    from stutter_tpu_torch.models.mlp import SeedMLP, init_mlp
    from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler

    import ref_wavlm

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
    ref = ref_wavlm.mlp_proba([torch.from_numpy(params[f"w{i}"]) for i in range(3)],
                            [torch.from_numpy(params[f"b{i}"]) for i in range(3)], emb).numpy()
    np.testing.assert_allclose([got[c] for c in "abc"], ref, atol=1e-5)


# ------------------------------------------------------------ tracing

def test_traced_extraction_opens_the_spans_and_counts_the_shapes(small, tmp_path):
    """Under a profiler, extract_features_numpy's encoder opens one
    `stp.w2v_bert.encode` a batch holding a `fbank` and, a layer, one
    `attention` and one `conv_module`; the counters add up to the batches'
    shapes (fitted_groups' batches at a stride of 320 samples): sum T_i
    frames valid and sent (the rows are packed: no padded frame is sent),
    sum T_i^2 attention pairs valid and sent, and the pairs the kernel
    multiplies, each clip's rows in warps of 16 by its keys in groups of
    8."""
    fc, _ = small
    clips = _clips((9000, 24576, 30000, 50000, 12000))
    before_c, before_s = P.counters(), len(P.spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        extract_features_numpy(clips, fc, batch_size=2, device="cpu")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("name", "").startswith("stp.w2v_bert.")]
    mem = P.spans()[before_s:]
    added = {k: v - before_c.get(k, 0) for k, v in P.counters().items()
             if k.startswith("w2v_bert.") and v != before_c.get(k, 0)}
    batches = [(N, [len(clips[i]) for i in idxs])
               for N, idxs in fitted_groups([len(y) for y in clips], 2, 320, DEFAULT_BUCKETS[-1])]
    t = [W.frame_lengths(len(y)) for y in clips]
    assert added == {"w2v_bert.batches": len(batches),
                     "w2v_bert.valid_frames": sum(t),
                     "w2v_bert.sent_frames": sum(t),
                     "w2v_bert.attn_pairs_valid": sum(x * x for x in t),
                     "w2v_bert.attn_pairs_sent": sum(x * x for x in t),
                     "w2v_bert.attn_pairs_run": sum(16 * -(-x // 16) * 8 * -(-x // 8) for x in t)}
    L = SMALL.num_hidden_layers
    for source in (names, ["stp." + s.name for s in mem if s.name.startswith("w2v_bert.")]):
        assert source.count("stp.w2v_bert.encode") == source.count("stp.w2v_bert.fbank") == len(batches)
        assert source.count("stp.w2v_bert.attention") == len(batches) * L
        assert source.count("stp.w2v_bert.conv_module") == len(batches) * L
    enc = [s for s in mem if s.name == "w2v_bert.encode"]
    inner = [s for s in mem if s.name in ("w2v_bert.fbank", "w2v_bert.attention",
                                          "w2v_bert.conv_module")]
    assert all(any(e.start_ns <= s.start_ns and s.end_ns <= e.end_ns for e in enc) for s in inner)
    assert os.path.getsize(path) > 0


def test_fitted_batches_give_each_clip_alone(small):
    """run_bucketed with the encoder's batch_fn (which carries its stride,
    320 samples: a frame pair) over 20 clips of mixed lengths, one past the
    largest bucket and one too short to give a frame, in batches of 4:
    each clip's row is encode of that clip alone, unpadded and cut to the
    cap."""
    from stutter_tpu_torch.ops.frontend import run_bucketed

    fc, p = small
    rng = np.random.RandomState(3)
    lengths = [170000, 300, *rng.randint(1000, 160000, 18)]
    clips = _clips(tuple(int(n) for n in lengths))
    fn = W.batch_fn_for(SMALL)
    assert fn.frame_stride == 320
    fitted = run_bucketed(clips, fn, 69, batch_size=4, device="cpu")
    cap = DEFAULT_BUCKETS[-1]
    with torch.no_grad():
        alone = [W.encode(p, torch.from_numpy(y[:cap])[None], torch.tensor([len(y[:cap])]),
                          SMALL)[0].numpy() for y in clips]
    assert not alone[1].any() and not fitted[1].any()
    assert max(_gap(x[:64], a) for x, a in zip(fitted, alone)) < TOL


# ------------------------------------------------------------ attention core

def _formula(p, i, q, k, v, frames, cfg):
    """The kernel's formula in float64, each clip on its own: over the rows
    and keys i, j < T_b of q, k, v [B, T, D], softmax_j((q_i . k_j + q_i .
    D[clamp(j - i, -64, 8) + 64]) / sqrt(head_dim)) v -> [T_b, D] a clip."""
    B, T, D = q.shape
    H = cfg.num_attention_heads
    dist = p[W.LAYER.format(i) + "self_attn.distance_embedding.weight"].double()
    out = []
    for b in range(B):
        n = int(frames[b])
        rel = (torch.arange(n)[None, :] - torch.arange(n)[:, None]).clamp(-64, 8) + 64
        qh, kh, vh = (t[b, :n].double().view(n, H, D // H).transpose(0, 1) for t in (q, k, v))
        s = (qh @ kh.transpose(1, 2) + (qh[:, :, None, :] * dist[rel][None]).sum(-1)) / math.sqrt(D // H)
        out.append((torch.softmax(s, -1) @ vh).transpose(0, 1).reshape(n, D))
    return out


@pytest.mark.parametrize("frames,T", [([7], 7), ([1], 1), ([0], 3), ([0, 5], 5),
                                      ([45, 30, 1, 0, 45], 47), ([130, 64, 65, 3], 131)])
def test_plain_attention_core_is_the_kernels_formula(frames, T):
    """relkey_attention's plain path on packed rows (each clip's frames of
    q, k, v [B, T, D] packed to [R, D], and their Clips, in; [R, D] out):
    each clip's rows are the kernel's formula in float64, with distances
    past both clamps: odd T, T = 1, ragged clips, clips of no frame (no
    row; a batch of none gives [0, D])."""
    p = _params(SMALL)
    B, D = len(frames), SMALL.hidden_size
    g = torch.Generator().manual_seed(T * 31 + B)
    q, k, v = (torch.randn(B, T, D, generator=g) for _ in range(3))
    f = torch.tensor(frames)
    idx = W.pack_index(f, T)
    got = W.relkey_attention(p, 1, *(t.reshape(B * T, D)[idx] for t in (q, k, v)),
                             W.pack_clips(f, "cpu"), SMALL)
    assert got.shape == (sum(frames), D)
    s = 0
    for ref in _formula(p, 1, q, k, v, f, SMALL):
        n = ref.shape[0]
        if n:
            assert float(((got[s : s + n].double() - ref).abs() / (1 + ref.abs())).max()) < 1e-5
        s += n


def test_distance_index_clamps_left_and_right():
    idx = W.distance_index(80, 64, 8)
    assert int(idx[70, 0]) == 0 and int(idx[64, 0]) == 0 and int(idx[63, 0]) == 1
    assert int(idx[0, 8]) == 72 and int(idx[0, 79]) == 72 and int(idx[5, 5]) == 64


def _bench_counts():
    """benchmark/counts/w2v_bert.py, loaded from its file as a package of
    its own name (its module imports `.work`)."""
    import importlib
    import importlib.util
    import sys

    root = REPO / "benchmark" / "counts"
    if "_bench_counts" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "_bench_counts", root / "__init__.py", submodule_search_locations=[str(root)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules["_bench_counts"] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module("_bench_counts.w2v_bert")


@pytest.mark.parametrize("frames", [[1], [45, 0, 30], [440, 136, 511], list(range(0, 600, 37))])
def test_kernel_phases_bound_counts_the_benchmarks_operations(frames):
    """kernel_phases.attention_ops of a W2VBertConfig, the numerator of the
    relative-key mode's bound in its phases, is the benchmark's count of one layer's attention
    core (counts.w2v_bert.attention) summed over the clips, at the
    published widths and at SMALL's."""
    from stutter_tpu_torch.tools.kernel_phases import attention_ops

    counts = _bench_counts()
    for cfg in (W2VBertConfig(), SMALL):
        enc = dataclasses.asdict(cfg)
        assert attention_ops(frames, cfg) == sum(counts.attention(t, enc)[0] for t in frames)


@pytest.mark.gpu
def test_tf32_fails_against_the_reference_on_the_card():
    """On the card, at the published widths and depth: the encoder's batch
    path at its own precision passes, and with TF32 on (its matmuls and
    convs in TF32) it reads over ten times the limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: TF32 exists only there")
    from stutter_tpu_torch.device import resolve_device

    dev = resolve_device("cuda:0")
    wide = W2VBertConfig(seed=3)
    c = dataclasses.asdict(wide)
    p = R.draw_params(c, wide.seed, dev)
    W.release()
    W.encoder_for(wide).replicas[dev] = p
    clips = [y[: DEFAULT_BUCKETS[-1]] for y in _clips()[:7]]
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
        assert sound < CARD_TOL and low > 10 * CARD_TOL
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        W.release()
