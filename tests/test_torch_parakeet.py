"""Parakeet-CTC-1.1B's FastConformer encoder (stutter_tpu_torch/models/
parakeet.py and its log-mel, ops/fbank.parakeet_features) on the CPU at a
small size -- hidden 64, 2 layers, 2 heads of 32, FFN 96, a stem of 8
channels, with the published 9-tap conv, x8 stem and 80 mels -- against
the plain reference (tests/ref_parakeet.py), which is held against
transformers' ParakeetEncoder.  The weights are the reference's
draw_params (every bias, LayerNorm, BatchNorm statistic and bias_u /
bias_v away from its published constant, so a port that leaves one out
shows), with the attention's projections at scale 0.3 so the positional
term shows in the output; and the host path's long recordings: nothing is
cut at the largest bucket on the encoder's path."""

import dataclasses
import filecmp
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import ref_parakeet as R
from stutter_tpu_torch.config import FEATURES_PARAKEET, EmbeddingFeatureConfig, ParakeetConfig
from stutter_tpu_torch.models import parakeet as PK
from stutter_tpu_torch.models import w2v_bert
from stutter_tpu_torch.ops import fbank as FB
from stutter_tpu_torch.ops import frontend
from stutter_tpu_torch.ops.frontend import (DEFAULT_BUCKETS, bucket_groups, extract_features_numpy,
                                            fitted_groups, run_bucketed)
from stutter_tpu_torch.utils import profiling as P

REPO = Path(__file__).resolve().parent.parent
SMALL = ParakeetConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                       intermediate_size=96, subsampling_conv_channels=8, seed=3)
TOL = 2e-5  # max |got - ref| / (1 + |ref|) of a sound port (readings ~7e-6)
FAULT = 2e-4  # a planted fault must read above this: ten times TOL
FBANK_TOL = 1e-4  # a normalised log-mel value, two FFT routes (readings up to 3e-5)


def _params(cfg: ParakeetConfig, device="cpu") -> dict:
    p = R.draw_params(dataclasses.asdict(cfg), cfg.seed, device)
    g = torch.Generator().manual_seed(cfg.seed + 1)
    for k in p:
        if "self_attn." in k and k.endswith("_proj.weight"):
            p[k] = (0.3 * torch.randn(p[k].shape, generator=g)).to(device)
    return p


@pytest.fixture
def small():
    """SMALL's features config, its weights installed as the encoder's on
    the CPU (the Encoder folds BatchNorm into a copy of them); the encoders
    dropped afterwards."""
    p = _params(SMALL)
    PK.release()
    PK.encoder_for(SMALL).replicas[torch.device("cpu")] = dict(p)
    yield EmbeddingFeatureConfig(encoder=SMALL), p
    PK.release()


def _clips(lengths=(9000, 24576, 30000, 50000, 12000, 200000, 60000, 100, 1200)):
    """Clips of mixed lengths: one past the largest bucket, one under a
    log-mel frame (no encoder frame), one of 7 log-mel frames."""
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
        if R.n_frames(len(y)) == 0:
            assert not x.any()
            continue
        worst = max(worst, _gap(x[:64], R.embed(p, y, c).numpy()))
    return worst


def test_port_matches_the_reference_across_fitted_batches(small):
    """extract_features_numpy over mixed lengths (fitted batches of 3, so
    padded rows of other lengths), a 12.5 s recording among them whole:
    each clip's embedding is the reference's, a clip of no encoder frame
    zero, the 5 text placeholders zero."""
    assert _worst_gap(*small, _clips()) < TOL


def test_embedding_is_the_same_alone_and_inside_a_padded_batch(small):
    """A recording's embedding does not depend on its batch: alone, and
    padded among longer ones to a length that is no multiple of the
    stride."""
    fc, p = small
    clips = _clips((12000, 150000, 100000))
    alone = extract_features_numpy(clips[:1], fc, device="cpu")[0]
    fn = PK.batch_fn_for(SMALL)
    audio = torch.zeros(3, 151003)
    for i, y in enumerate(clips):
        audio[i, : len(y)] = torch.from_numpy(y)
    with torch.no_grad():
        padded = fn(audio, torch.tensor([len(y) for y in clips]))[0].numpy()
    np.testing.assert_allclose(padded, alone, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [320, 479, 1279, 1280, 1281, 8000, 16399, 163840])
def test_fbank_of_a_clip_alone_and_in_a_batch_is_the_references(n):
    """ops/fbank.parakeet_features of a clip alone and as the short row of
    a padded batch (beside a longer clip, the padding nonzero past the
    clip) equal the reference's fbank; the frames past the clip's L // 160
    are zero; frame_lengths halves L // 160 three times.  (A clip of one
    frame has no ddof-1 variance: the extractor divides 0 by 0.)"""
    y = _clips((n,))[0]
    other = _clips((n + 3333,))[0]
    T = n // 160
    assert FB.parakeet_n_frames(n) == T
    assert PK.frame_lengths(n) == R.n_frames(n) == (((T + 1) // 2 + 1) // 2 + 1) // 2
    ref = R.fbank(torch.from_numpy(y)).numpy()
    alone, n_alone = FB.parakeet_features(torch.from_numpy(y)[None], torch.tensor([n]))
    assert int(n_alone[0]) == T and alone.shape[1] == ref.shape[0] == 1 + n // 160
    # FBANK_TOL: torch.stft's and the port's rfft round apart by ~1e-7 of a
    # bin's log-mel, which the normalisation's 1 / std magnifies
    np.testing.assert_allclose(alone[0].numpy(), ref, rtol=0, atol=FBANK_TOL)
    audio = torch.zeros(2, n + 3333)
    audio[0, :n] = torch.from_numpy(y)
    audio[0, n:] = 0.7  # padding that a frame must not read
    audio[1] = torch.from_numpy(other)
    batch, frames = FB.parakeet_features(audio, torch.tensor([n, n + 3333]))
    np.testing.assert_allclose(batch[0, : ref.shape[0]].numpy(), ref, rtol=0, atol=FBANK_TOL)
    assert not batch[0, T:].any() and int(frames[0]) == T


def _extractor_steps():
    """ParakeetFeatureExtractor's _torch_extract_fbank_features and its two
    constants, compiled from transformers' source file (importing the
    module needs librosa, for its mel filters alone)."""
    import ast
    import importlib.util

    spec = importlib.util.find_spec("transformers")
    if spec is None:
        pytest.skip("transformers is not installed")
    path = Path(spec.submodule_search_locations[0]) / "models" / "parakeet" / \
        "feature_extraction_parakeet.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body if isinstance(n, ast.Assign)
            and n.targets[0].id in ("EPSILON", "LOG_ZERO_GUARD_VALUE")]
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef))
    keep += [n for n in cls.body if isinstance(n, ast.FunctionDef)
             and n.name == "_torch_extract_fbank_features"]
    ns = {"torch": torch}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    return ns


def test_fbank_matches_the_extractors_torch_steps():
    """The port's log-mel is ParakeetFeatureExtractor's steps (its torch
    STFT, the magnitude squared, the mel product, log(x + 2^-24), the
    masked normalisation, as __call__ runs them) with the slaney filters
    from ops/filterbanks in place of librosa's, on a padded batch."""
    ns = _extractor_steps()
    ext = type("Ext", (), {})()
    ext.hop_length, ext.n_fft, ext.win_length, ext.preemphasis = 160, 512, 400, 0.97
    ext.mel_filters = torch.from_numpy(frontend_mel())
    clips = _clips((9000, 30000, 16399))
    N = max(len(y) for y in clips)
    audio = torch.zeros(len(clips), N)
    for i, y in enumerate(clips):
        audio[i, : len(y)] = torch.from_numpy(y)
    lengths = torch.tensor([len(y) for y in clips])
    # __call__'s steps, in its order
    x = torch.cat([audio[:, :1], audio[:, 1:] - 0.97 * audio[:, :-1]], dim=1)
    x = x.masked_fill(~(torch.arange(N)[None] < lengths[:, None]), 0.0)
    mel = ns["_torch_extract_fbank_features"](ext, x)
    n = torch.floor_divide(lengths + 512 // 2 * 2 - 512, 160)
    mask = (torch.arange(mel.shape[1])[None, :] < n[:, None])[..., None]
    masked = mel * mask
    mean = (masked.sum(1) / n[:, None])[:, None]
    std = torch.sqrt((((masked - mean) ** 2) * mask).sum(1) / (n - 1)[:, None])[:, None]
    want = (mel - mean) / (std + ns["EPSILON"]) * mask
    got, frames = FB.parakeet_features(audio, lengths)
    assert torch.equal(frames, n) and ns["LOG_ZERO_GUARD_VALUE"] == FB.PK_LOG_GUARD
    assert float((got - want).abs().max()) < FBANK_TOL


def frontend_mel() -> np.ndarray:
    from stutter_tpu_torch.ops.filterbanks import mel_filterbank

    return mel_filterbank(16000, 512, 80, 0.0, 8000.0)


def test_reference_mel_filters_are_librosas_formula():
    """The reference's own slaney filters equal ops/filterbanks'
    (librosa.filters.mel(norm="slaney")'s formula)."""
    np.testing.assert_allclose(R.mel_bank().numpy(), frontend_mel(), rtol=0, atol=1e-7)


def test_stem_of_each_clip_is_the_references():
    """subsample on a padded batch: each clip's first T frames are the
    reference's stem of that clip alone (its time masks after every conv,
    the channel-major flatten), T the three halvings of L // 160."""
    p = _params(SMALL)
    clips = _clips((9000, 30000, 4000))
    N = 30000
    audio = torch.zeros(3, N)
    for i, y in enumerate(clips):
        audio[i, : len(y)] = torch.from_numpy(y)
    lengths = torch.tensor([len(y) for y in clips])
    feats, n = FB.parakeet_features(audio, lengths)
    x, t = PK.subsample(p, feats, n, SMALL)
    assert t.tolist() == [PK.frame_lengths(len(y)) for y in clips]
    c = dataclasses.asdict(SMALL)
    for i, y in enumerate(clips):
        f1 = R.fbank(torch.from_numpy(y))
        T = R.n_frames(len(y), c)
        lin = F.linear(x[i, :T], p["subsampling.linear.weight"], p["subsampling.linear.bias"])
        # the reference's stem output, read back through its first layer's input
        h = R.hidden_states(p, f1, len(y) // 160, {**c, "num_hidden_layers": 0})
        np.testing.assert_allclose(lin.numpy() * math.sqrt(SMALL.hidden_size), h.numpy(),
                                   rtol=0, atol=2e-5 * (1 + float(h.abs().max())))


@pytest.mark.parametrize("layers", [1, 2])
def test_packed_encode_matches_the_reference_on_a_ragged_batch(layers):
    """encode on a ragged batch (one clip of no frame): one block and the
    whole encoder give each clip the reference's embedding."""
    cfg = dataclasses.replace(SMALL, num_hidden_layers=layers)
    p = _params(cfg)
    clips = _clips((9000, 30000, 100, 16399))
    N = 30720
    audio = torch.zeros(len(clips), N)
    for i, y in enumerate(clips):
        audio[i, : len(y)] = torch.from_numpy(y)
    with torch.no_grad():
        e = PK.encode(PK.fold_batchnorm(dict(p), cfg), audio,
                      torch.tensor([len(y) for y in clips]), cfg).numpy()
    c = dataclasses.asdict(cfg)
    assert not e[2].any()
    for i in (0, 1, 3):
        assert _gap(e[i], R.embed(p, clips[i], c).numpy()) < TOL


def test_reference_matches_transformers(monkeypatch):
    """The reference's last hidden state is transformers.ParakeetEncoder's
    on each recording with the extractor's attention mask (its last frame
    padding), on the same weights loaded by the checkpoint's names, the
    features the reference's own fbank.  The lengths leave the stem no row
    past the recording's frames: eager attention fills a fully masked row
    with NaN, and its keys spread it (transformers' batched path with
    padding gives NaN)."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    pytest.importorskip("transformers")
    from transformers import ParakeetEncoder, ParakeetEncoderConfig

    c = dataclasses.asdict(SMALL)
    hf = ParakeetEncoderConfig(**{k: v for k, v in c.items() if k not in ("seed", "weights")},
                               dropout=0.0, layerdrop=0.0, activation_dropout=0.0,
                               attention_dropout=0.0)
    hf._attn_implementation = "eager"
    model = ParakeetEncoder(hf).eval()
    p = _params(SMALL)
    missing, unexpected = model.load_state_dict(p, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    # L // 160 = 8k - 1 log-mel frames: the stem's rows of them and of 8k are both k
    clips = _clips((160 * 55 + 50, 160 * 183 + 7, 160 * 103 + 100))
    for y in clips:
        f = R.fbank(torch.from_numpy(y))
        mask = torch.arange(f.shape[0])[None] < len(y) // 160
        with torch.no_grad():
            out = model(f[None], attention_mask=mask).last_hidden_state[0]
        ref = R.hidden_states(p, f, len(y) // 160, c)
        assert out.shape[0] == ref.shape[0] == R.n_frames(len(y))
        assert float((out - ref).abs().max()) < 2e-5


def test_published_parameter_count_and_feature_width(monkeypatch):
    """Parakeet-CTC-1.1B's encoder parameters reckoned from the shapes,
    nothing allocated: 1,061,489,664 (25,207,808 a block, 2,761,728 in the
    stem; BatchNorm's running statistics are buffers), transformers'
    encoder on the meta device name for name and shape; its features are
    1024 + 5 wide; a recording of max_position_embeddings frames is the
    batch_fn's longest whole."""
    cfg = ParakeetConfig()
    assert PK.n_params(cfg) == 1_061_489_664
    assert PK.n_params(dataclasses.replace(cfg, num_hidden_layers=1)) == 25_207_808 + 2_761_728
    assert R.param_shapes(dataclasses.asdict(cfg)) == PK.param_shapes(cfg)
    assert FEATURES_PARAKEET.total_feature_len == 1029
    assert len(FEATURES_PARAKEET.feature_names()) == 1029
    fn = PK.batch_fn_for(cfg)
    assert fn.frame_stride == 1280 and fn.max_samples == 6_400_000
    assert PK.frame_lengths(fn.max_samples) == cfg.max_position_embeddings
    PK.release()
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    pytest.importorskip("transformers")
    from transformers import ParakeetEncoder, ParakeetEncoderConfig

    with torch.device("meta"):
        model = ParakeetEncoder(ParakeetEncoderConfig(num_hidden_layers=42))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == PK.param_shapes(cfg)
    assert sum(v.numel() for v in model.parameters()) == 1_061_489_664


def test_the_two_reference_copies_are_byte_identical():
    assert filecmp.cmp(REPO / "tests" / "ref_parakeet.py",
                       REPO / "benchmark" / "reference" / "parakeet.py", shallow=False)


def test_reference_imports_only_torch():
    """The reference imports torch and math alone: no JAX, no port code, no
    kernel."""
    src = (REPO / "tests" / "ref_parakeet.py").read_text()
    imports = sorted({line.split()[1].split(".")[0] for line in src.splitlines()
                      if line.startswith(("import ", "from "))})
    assert imports == ["math", "torch"]


# ------------------------------------------------------------ faults

def _flip_sign(T, D, device):
    return R_ORIG["sinusoids"](T, D, device).flip(0)


def _shift_one(T, D, device):
    return R_ORIG["sinusoids"](T, D, device).roll(1, 0)


def _unfolded(p, cfg):
    for i in range(cfg.num_hidden_layers):
        pre = PK.LAYER.format(i)
        p[pre + PK.FOLDED + "weight"] = p[pre + "conv.depthwise_conv.weight"][:, 0].contiguous()
        p[pre + PK.FOLDED + "bias"] = p[pre + "conv.depthwise_conv.bias"]
    return p


def _stats_ignored(p, cfg):
    q = dict(p)
    for i in range(cfg.num_hidden_layers):
        bn = PK.LAYER.format(i) + "conv.norm."
        q[bn + "running_mean"] = torch.zeros_like(p[bn + "running_mean"])
        q[bn + "running_var"] = torch.ones_like(p[bn + "running_var"])
    folded = R_ORIG["fold_batchnorm"](q, cfg)
    p.update({k: v for k, v in folded.items() if PK.FOLDED in k})
    return p


def _mel_major(p, feats, n, cfg):
    x, t = R_ORIG["subsample"](p, feats, n, cfg)
    B, T, _ = x.shape
    C = cfg.subsampling_conv_channels
    return x.view(B, T, C, -1).transpose(2, 3).reshape(B, T, -1), t


def _causal(x, w, b, clips):
    return w2v_bert.depthwise_conv(x, w[:, None, :], clips) + b


def _over_padding(feats, n):
    return R_ORIG["parakeet_normalise"](feats, torch.full_like(n, feats.shape[1]))


R_ORIG = {"sinusoids": PK.sinusoids, "fold_batchnorm": PK.fold_batchnorm,
          "subsample": PK.subsample, "parakeet_normalise": FB.parakeet_normalise}
# fault -> (module, name, replacement)
FAULTS = {"bias_v dropped": None,
          "sign of i - j flipped": (PK, "sinusoids", _flip_sign),
          "rel-shift off by one": (PK, "sinusoids", _shift_one),
          "BatchNorm left unfolded": (PK, "fold_batchnorm", _unfolded),
          "running statistics ignored": (PK, "fold_batchnorm", _stats_ignored),
          "stem time masks skipped": (PK, "_time_mask", lambda x, t: x),
          "stem flattened mel-major": (PK, "subsample", _mel_major),
          "depthwise conv causal": (PK, "centred_conv", _causal),
          "normalised over padding": (FB, "parakeet_normalise", _over_padding)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_against_the_reference(fault, monkeypatch):
    """Each fault planted in the port reads over FAULT (ten times TOL)
    against the reference across fitted batches, the sound port under
    TOL."""
    p = _params(SMALL)
    port = dict(p)
    if FAULTS[fault] is None:
        for i in range(SMALL.num_hidden_layers):
            k = PK.LAYER.format(i) + "self_attn.bias_v"
            port[k] = torch.zeros_like(p[k])
    else:
        mod, name, fn = FAULTS[fault]
        monkeypatch.setattr(mod, name, fn)
    PK.release()
    PK.encoder_for(SMALL).replicas[torch.device("cpu")] = port
    try:
        gap = _worst_gap(EmbeddingFeatureConfig(encoder=SMALL), p,
                         _clips((9000, 30000, 16399, 50000)))
    finally:
        PK.release()
    assert gap > FAULT, gap


# ------------------------------------------------------------ long recordings

def test_a_60_s_recording_comes_back_whole_through_the_gate_and_the_encoder(small, monkeypatch):
    """denoise_clips pads a 60 s recording to a multiple of the largest
    bucket and hands it back whole; run_bucketed with the encoder's
    batch_fn (max_samples 6,400,000) cuts nothing: the embedding is the
    reference's of the whole recording, and the traced cut_samples of both
    callers are 0 (a 149-dim batch_fn still cuts at the largest bucket)."""
    import stutter_tpu_torch.denoise as dn

    fc, p = small
    clips = _clips((960000, 30000, 200000))
    monkeypatch.setattr(dn, "denoise_batch", lambda audio, lengths, cfg: audio * 0.5)
    before = P.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        clean = dn.denoise_clips(clips, batch_size=2, device="cpu")
        X = run_bucketed(clean, PK.batch_fn_for(SMALL), 69, batch_size=2, device="cpu")
        cut = run_bucketed(clips, lambda a, n: torch.stack([n.float(), n.float()], 1), 2,
                           batch_size=2, device="cpu")
    added = {k: v - before.get(k, 0) for k, v in P.counters().items()}
    assert [len(y) for y in clean] == [len(y) for y in clips]
    assert all(np.array_equal(c, 0.5 * y) for c, y in zip(clean, clips))
    assert added.get("denoise_clips.cut_samples", 0) == 0
    assert added["denoise_clips.valid_samples"] == sum(len(y) for y in clips)
    assert added["run_bucketed.valid_samples"] == 2 * sum(len(y) for y in clips) - sum(
        max(len(y) - DEFAULT_BUCKETS[-1], 0) for y in clips)
    assert added["run_bucketed.cut_samples"] == sum(max(len(y) - DEFAULT_BUCKETS[-1], 0)
                                                    for y in clips)
    assert cut[:, 0].tolist() == [min(len(y), DEFAULT_BUCKETS[-1]) for y in clips]
    c = dataclasses.asdict(SMALL)
    assert _gap(X[0, :64], R.embed(p, clean[0], c).numpy()) < TOL


def _mix_lengths(name: str) -> list[int]:
    sys.path.insert(0, str(REPO / "benchmark"))
    try:
        import gen
    finally:
        sys.path.remove(str(REPO / "benchmark"))
    mix = json.loads((REPO / "benchmark" / "mixes" / f"{name}.json").read_text())
    return [int(d * 16000) for d in gen.lengths_s(mix["clips"], mix["lengths"])]


@pytest.mark.parametrize("mix", ["embed_905", "corpus_905"])
def test_the_corpus_cells_get_todays_groups(mix):
    """At the corpus cells' clip lengths (none past the largest bucket) the
    gate's groups with long recordings kept whole are the cut groups, and
    run_bucketed's fitted groups for an encoder batch_fn with no
    max_samples (WavLM's, W2V-BERT's) keep the largest bucket as the cap."""
    lengths = _mix_lengths(mix)
    assert max(lengths) <= DEFAULT_BUCKETS[-1]
    assert bucket_groups(lengths, 64, whole=True) == bucket_groups(lengths, 64)
    formed = []

    def fn(audio, lengths):
        return audio.new_zeros(audio.shape[0], 1)

    fn.frame_stride = 320
    orig = frontend.fitted_groups

    def spy(*a):
        formed.append(a)
        return orig(*a)

    frontend.fitted_groups = spy
    try:
        run_bucketed([np.zeros(1, np.float32)], fn, 1, batch_size=64, device="cpu")
    finally:
        frontend.fitted_groups = orig
    assert formed[0][3] == DEFAULT_BUCKETS[-1]
    assert fitted_groups(lengths, 64, 320, DEFAULT_BUCKETS[-1]) == fitted_groups(
        lengths, 64, 320, 6_400_000)


# ------------------------------------------------------------ weights

def test_weights_round_trip_through_persist_by_checkpoint_name(tmp_path):
    """save_wavlm / load_wavlm keep every parameter and BatchNorm statistic
    under its checkpoint name, bit for bit; a config whose shapes differ is
    refused; a config naming the file runs on those weights, BatchNorm
    folded into its copy once."""
    from stutter_tpu_torch import persist

    p = _params(SMALL)
    path = tmp_path / "parakeet.npz"
    persist.save_wavlm(path, p)
    back = persist.load_wavlm(path, SMALL, device="cpu")
    assert list(back) == list(PK.param_shapes(SMALL))
    assert all(torch.equal(back[k], p[k]) for k in p)
    with pytest.raises(ValueError):
        persist.load_wavlm(path, dataclasses.replace(SMALL, num_hidden_layers=3), device="cpu")
    cfg = dataclasses.replace(SMALL, weights=str(path), seed=99)
    PK.release()
    try:
        got = PK.encoder_for(cfg).params("cpu")
        assert all(torch.equal(got[k], p[k]) for k in p)
        folded = [k for k in got if PK.FOLDED in k]
        assert len(folded) == 2 * SMALL.num_hidden_layers
        assert PK.encoder_for(cfg).params("cpu")[folded[0]] is got[folded[0]]
    finally:
        PK.release()


def test_without_a_checkpoint_the_weights_are_drawn_from_the_seed():
    """A config naming no weights draws them from its seed, under the
    checkpoint's names and shapes, at the published initial values: the
    same seed the same weights; LayerNorm and BatchNorm ones and zeros,
    the running variance one, biases zero, the Linears std 0.02."""
    p = PK.init_params(SMALL, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == PK.param_shapes(SMALL)
    again = PK.init_params(SMALL, "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    bn = PK.LAYER.format(0) + "conv.norm."
    assert bool((p[bn + "weight"] == 1).all()) and not p[bn + "bias"].any()
    assert not p[bn + "running_mean"].any() and bool((p[bn + "running_var"] == 1).all())
    assert bool((p[PK.LAYER.format(1) + "norm_out.weight"] == 1).all())
    assert not p[PK.LAYER.format(0) + "feed_forward2.linear2.bias"].any()
    q = p[PK.LAYER.format(0) + "self_attn.q_proj.weight"]
    assert abs(float(q.std()) - 0.02) < 0.005


def test_folding_batchnorm_is_batchnorm_after_the_conv():
    """The folded taps and bias give the depthwise conv's output under
    BatchNorm in eval."""
    p = _params(SMALL)
    folded = PK.fold_batchnorm(dict(p), SMALL)
    pre = PK.LAYER.format(1)
    x = torch.randn(1, SMALL.hidden_size, 40)
    conv = F.conv1d(x, p[pre + "conv.depthwise_conv.weight"], p[pre + "conv.depthwise_conv.bias"],
                    padding=4, groups=SMALL.hidden_size)
    want = F.batch_norm(conv, p[pre + "conv.norm.running_mean"], p[pre + "conv.norm.running_var"],
                        p[pre + "conv.norm.weight"], p[pre + "conv.norm.bias"], training=False,
                        eps=1e-5)
    got = F.conv1d(x, folded[pre + PK.FOLDED + "weight"][:, None], folded[pre + PK.FOLDED + "bias"],
                   padding=4, groups=SMALL.hidden_size)
    assert float((got - want).abs().max()) < 1e-5


# ------------------------------------------------------------ cores

@pytest.mark.parametrize("frames", [[1, 4, 5, 9, 30], [30, 0, 1, 0], [2, 2, 2], [9]])
def test_plain_centred_conv_equals_conv1d_on_each_clip_alone(frames):
    """centred_conv on packed rows: each clip's rows equal F.conv1d with
    padding 4 and the bias over that clip alone (the rows of the clips
    beside it never read)."""
    g = torch.Generator().manual_seed(2)
    C = 32
    x = torch.randn(sum(frames), C, generator=g)
    w, b = torch.randn(C, 9, generator=g), torch.randn(C, generator=g)
    clips = w2v_bert.pack_clips(frames, "cpu")
    got = PK.centred_conv(x, w, b, clips)
    s = 0
    for n in frames:
        if n:
            want = F.conv1d(x[s : s + n].T[None], w[:, None], b, padding=4, groups=C)[0].T
            assert float((got[s : s + n] - want).abs().max()) < 1e-5
        s += n


@pytest.mark.parametrize("frames", [[7], [1], [0, 5], [13, 40, 0, 29]])
def test_plain_attention_core_is_the_formula(frames):
    """xl_attention_plain on packed rows equals the float64 formula
    softmax(((q + u) k^T + (q + v) P[i - j]^T) / sqrt(d)) v clip by clip,
    P the table row T' - 1 + i - j, over a table longer than the clips
    need."""
    g = torch.Generator().manual_seed(5)
    cfg = dataclasses.replace(SMALL, hidden_size=64, num_attention_heads=2)
    H, dh, D = 2, 32, 64
    R_ = sum(frames)
    q, k, v = (torch.randn(R_, D, generator=g) for _ in range(3))
    Tp = max(frames) + 3
    pos = torch.randn(2 * Tp - 1, D, generator=g)
    pre = PK.LAYER.format(0) + "self_attn."
    p = {pre + "bias_u": torch.randn(H, dh, generator=g), pre + "bias_v": torch.randn(H, dh, generator=g)}
    clips = w2v_bert.pack_clips(frames, "cpu")
    got = PK.xl_attention_plain(p, 0, q, k, v, pos, clips, cfg).double()
    s = 0
    for n in frames:
        if n:
            qq, kk, vv = (t[s : s + n].double().view(n, H, dh).transpose(0, 1) for t in (q, k, v))
            i = torch.arange(n)
            Pm = pos.double()[(i[:, None] - i[None, :]) + Tp - 1].view(n, n, H, dh)
            u, vb = (p[pre + x].double()[:, None] for x in ("bias_u", "bias_v"))
            sc = ((qq + u) @ kk.transpose(1, 2) + torch.einsum("hid,ijhd->hij", qq + vb, Pm))
            o = (torch.softmax(sc / math.sqrt(dh), -1) @ vv).transpose(0, 1).reshape(n, D)
            assert float((got[s : s + n] - o).abs().max()) < 1e-5
        s += n


def test_traced_extraction_opens_the_spans_and_counts_the_shapes(small, tmp_path):
    """Under a profiler, extract_features_numpy's encoder opens one
    `stp.parakeet.encode` a batch holding a `fbank`, a `subsample` and, a
    layer, one `pos`, one `attention` and one `conv_module`; the counters
    add up to the batches' shapes (fitted_groups' batches at a stride of
    1280 samples): sum T_i frames valid and sent, sum T_i^2 pairs valid and
    sent, the kernel's pairs (rows in warps of 16 by keys in groups of 8),
    its positional products (rows in warps of 16 by the keys in tiles of
    32, plus 64), and 2 T_max - 1 positional rows a batch."""
    fc, _ = small
    clips = _clips((9000, 24576, 30000, 50000, 12000))
    before_c, before_s = P.counters(), len(P.spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        extract_features_numpy(clips, fc, batch_size=2, device="cpu")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("name", "").startswith("stp.parakeet.")]
    mem = P.spans()[before_s:]
    added = {k: v - before_c.get(k, 0) for k, v in P.counters().items()
             if k.startswith("parakeet.") and v != before_c.get(k, 0)}
    batches = [[PK.frame_lengths(len(clips[i])) for i in idxs]
               for _, idxs in fitted_groups([len(y) for y in clips], 2, 1280, 6_400_000)]
    t = [x for b in batches for x in b]
    assert added == {"parakeet.batches": len(batches),
                     "parakeet.valid_frames": sum(t), "parakeet.sent_frames": sum(t),
                     "parakeet.attn_pairs_valid": sum(x * x for x in t),
                     "parakeet.attn_pairs_sent": sum(x * x for x in t),
                     "parakeet.attn_pairs_run": sum(16 * -(-x // 16) * 8 * -(-x // 8) for x in t),
                     "parakeet.pos_products_run": sum(16 * -(-x // 16) * (32 * -(-x // 32) + 64)
                                                      for x in t),
                     "parakeet.pos_rows": sum(2 * max(b) - 1 for b in batches)}
    L = SMALL.num_hidden_layers
    for source in (names, ["stp." + s.name for s in mem if s.name.startswith("parakeet.")]):
        for leaf in ("encode", "fbank", "subsample"):
            assert source.count(f"stp.parakeet.{leaf}") == len(batches)
        for leaf in ("pos", "attention", "conv_module"):
            assert source.count(f"stp.parakeet.{leaf}") == len(batches) * L


@pytest.mark.parametrize("frames,pairs,products", [
    ([1], 16 * 8, 16 * (32 + 64)),
    ([0, 5], 16 * 8, 16 * (32 + 64)),
    ([33], 48 * 40, 48 * (64 + 64)),
    ([16, 17, 0], 16 * 16 + 32 * 24, 16 * (32 + 64) + 32 * (32 + 64)),
    ([64, 65], 64 * 64 + 80 * 72, 64 * (64 + 64) + 80 * (96 + 64)),
])
def test_kernel_counts_follow_its_tiling(frames, pairs, products):
    """attn_pairs_run and pos_products_run, counted by hand: each clip's
    rows in warps of 16 by its keys in groups of 8 (q k^T), and by its
    keys in tiles of 32 plus the 64 distances above a query tile (the
    positional half's blocks of 32 distances); a clip of no frame none."""
    assert PK.ATTN_KEYS == 32
    assert PK.attn_pairs_run(frames) == pairs
    assert PK.pos_products_run(frames) == products
    assert PK.attn_pairs_run(torch.tensor(frames)) == pairs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the attention kernel runs only there")
    from stutter_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(2, 45), (1, 1), (4, 301), (1, 5000)])
def test_xl_kernel_matches_plain_at_the_edges_of_its_tiling(cuda, B, T):
    """The Transformer-XL mode of csrc/gated_attention.cu at the edges of
    its tiles (keys and positional blocks of 32, a score ring of 96
    distances): 45 frames, not a multiple of the key tile, beside a clip
    of no frames; one frame; 301 frames, past two ring lengths, in a
    ragged batch with a clip of no frames; 5,000 frames, the encoder's
    max_samples.  Every clip's rows within 1e-5 of xl_attention_plain on
    the CPU, one launch a call, and the pairs and positional products the
    kernel reports equal to attn_pairs_run and pos_products_run x heads."""
    from stutter_tpu_torch.tools.kernel_phases import attention_check

    res = attention_check(B, T, cuda, "xl")
    assert res["gap"] <= 1e-5, res["gap"]
    assert res["launches"] == 1
    assert res["pairs"] == res["pairs_run"], (res["pairs"], res["pairs_run"])
    assert res["pos_products"] == res["pos_products_run"], (res["pos_products"],
                                                            res["pos_products_run"])
    assert res["counted_call_equal"]


@pytest.mark.gpu
def test_xl_kernel_holds_the_blocks_an_sm_its_design_states(cuda):
    """The card puts ATTN_BLOCKS_PER_SM blocks of the XL mode on an SM
    (its shared memory and registers allow it)."""
    assert PK.ATTN_BLOCKS_PER_SM == 2
    assert PK.xl_blocks_per_sm(cuda) == PK.ATTN_BLOCKS_PER_SM


@pytest.mark.parametrize("frames", [[1], [45, 0, 30], [719, 978, 1317, 1856]])
def test_kernel_phases_bound_counts_the_benchmarks_operations(frames):
    """kernel_phases.attention_ops for Parakeet is the benchmark's count
    of the attention core (counts/parakeet.py attention)."""
    from stutter_tpu_torch.tools.kernel_phases import attention_ops

    sys.path.insert(0, str(REPO / "benchmark"))
    try:
        from counts import parakeet as counts
    finally:
        sys.path.remove(str(REPO / "benchmark"))
    cfg = ParakeetConfig()
    enc = json.loads((REPO / "benchmark" / "configs" / "parakeet_ctc_1.1b.json").read_text())["encoder"]
    assert attention_ops(frames, cfg) == sum(counts.attention(t, enc)[0] for t in frames)


@pytest.mark.gpu
def test_tf32_fails_against_the_reference_on_the_card():
    """On the card, at the published widths and depth: the encoder's batch
    path at its own precision passes, and with TF32 on it reads over ten
    times the limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: TF32 exists only there")
    from stutter_tpu_torch.device import resolve_device

    dev = resolve_device("cuda:0")
    wide = ParakeetConfig(seed=3)
    c = dataclasses.asdict(wide)
    p = R.draw_params(c, wide.seed, dev)
    PK.release()
    PK.encoder_for(wide).replicas[dev] = dict(p)
    clips = _clips((160000, 30000, 200000, 9000))
    ref = [R.embed(p, y, c).cpu().numpy() for y in clips]
    N = -(-max(len(y) for y in clips) // 1280) * 1280
    audio = torch.zeros(len(clips), N, device=dev)
    for i, y in enumerate(clips):
        audio[i, : len(y)] = torch.from_numpy(y)
    lengths = torch.tensor([len(y) for y in clips], device=dev)
    fn = PK.batch_fn_for(wide)

    def worst():
        with torch.no_grad():
            X = fn(audio, lengths).cpu().numpy()
        return max(_gap(x[:1024], r) for x, r in zip(X, ref))

    try:
        sound = worst()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        low = worst()
        print(f"sound {sound:.3e} tf32 {low:.3e}")
        assert sound < 1e-4 and low > 1e-3
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        PK.release()
