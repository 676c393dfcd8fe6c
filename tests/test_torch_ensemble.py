"""The port's weighted vote (EnsemblePredictor) and both streams against the
JAX package on the CPU, on artifacts the JAX package wrote: the production
quint (cnn, cnn_bilstm and three transformer recipes, 3 classes) with the
JAX init's weights perturbed from numpy seeds, plus MLP members."""

import json
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CLASSES = ["a", "b", "c"]
QUINT = ["cnn", "cnn_bilstm", "transformer", "transformer_lr1e3", "transformer_mix4_lr1e3"]
WEIGHTS = dict(zip(QUINT, [0.3, 0.2, 0.2, 0.15, 0.15]))


def _clips():
    rng = np.random.RandomState(31)
    t = np.arange(24576) / 16000
    return [(0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(24576)).astype(np.float32),
            (0.2 * rng.randn(20000)).astype(np.float32),
            (0.4 * np.sin(2 * np.pi * 700 * t[:9000]) + 0.02 * rng.randn(9000)).astype(np.float32)]


def _write_ensemble(out: str, weights: dict) -> None:
    with open(os.path.join(out, "ensemble.json"), "w") as f:
        json.dump({"weights": weights, "classes": CLASSES}, f)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The quint's heads, an MLP member set (engine B's, the clean and the
    raw+clean ones) and the label encoder, in the JAX package's files."""
    from stutter_tpu import persist
    from stutter_tpu.models.scaler import LabelEncoder, StandardScaler
    from stutter_tpu.train.seq_pipeline import ARCHS, persist_seq_head
    from stutter_tpu.train.trainer import FittedMLP, MLPTrainConfig

    out = tmp_path_factory.mktemp("ens")
    rng = np.random.RandomState(32)
    for i, arch in enumerate(QUINT):
        spec = ARCHS[arch]
        params = spec["init_fn"](jax.random.PRNGKey(i), **spec["init_kwargs"](3))
        params = {k: (np.asarray(v) + 0.05 * rng.randn(*np.shape(v))).astype(np.float32)
                  for k, v in params.items()}
        D = 60 if arch == "cnn_bilstm" else 128
        persist_seq_head(str(out), arch, params,
                         (rng.randn(D) - (30 if D == 128 else 0)).astype(np.float32),
                         (1 + 10 * rng.rand(D)).astype(np.float32), CLASSES)
    for name, dim in (("mlp_tpu", 149), ("mlp_clean_tpu", 149), ("mlp_both_tpu", 298)):
        dims = (dim, 16, 3)
        params = {}
        for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"w{j}"] = (rng.randn(2, a, b) * np.sqrt(2.0 / a)).astype(np.float32)
            params[f"b{j}"] = (rng.randn(2, b) * 0.1).astype(np.float32)
        persist.save_mlp(os.path.join(out, f"model_{name}"),
                         FittedMLP(params=params, n_seeds=2,
                                   cfg=MLPTrainConfig(hidden=(16,), n_classes=3)))
        scaler = StandardScaler.fit(rng.randn(20, dim).astype(np.float32) * 5)
        fname = {"mlp_tpu": "after", "mlp_clean_tpu": "clean", "mlp_both_tpu": "both"}[name]
        persist.save_scaler(os.path.join(out, f"scaler_{fname}.npz"), scaler)
    persist.save_label_encoder(os.path.join(out, "label_encoder.json"),
                               LabelEncoder(classes_=CLASSES))
    return out


def _pair(out, weights):
    """(the port's EnsemblePredictor, the JAX one) for these weights."""
    from stutter_tpu.config import PipelineConfig as JConfig
    from stutter_tpu.infer import EnsemblePredictor as JEnsemble
    from stutter_tpu_torch.infer import EnsemblePredictor

    _write_ensemble(str(out), weights)
    return (EnsemblePredictor.load(str(out), device="cpu"),
            JEnsemble.load(str(out), JConfig()))


@pytest.fixture(scope="module")
def quint(workspace):
    return _pair(workspace, WEIGHTS)


def _max_diff(a: dict, b: dict) -> float:
    return max(abs(a[c] - b[c]) for c in CLASSES)


@pytest.mark.parametrize("denoise", [False, True])
def test_quint_members_and_vote_match_jax(quint, denoise):
    """Every member's probabilities and the vote within 1e-4 of the JAX
    EnsemblePredictor with denoise off; with the gate on within 1e-3 and
    the same labels."""
    ours, theirs = quint
    assert sorted(ours.members) == sorted(QUINT)
    names, groups = ours._seq
    assert len(groups) == 3  # the three transformers run as one stacked forward
    tol = 1e-3 if denoise else 1e-4
    for y in _clips():
        r, rj = ours.predict_clip(y, denoise=denoise), theirs.predict_clip(y, denoise=denoise)
        assert r["label"] == rj["label"]
        assert _max_diff(r["proba"], rj["proba"]) < tol
        for name in QUINT:
            assert _max_diff(r["members"][name], rj["members"][name]) < tol
        expect = sum(WEIGHTS[n] * np.array([r["members"][n][c] for c in CLASSES]) for n in QUINT)
        np.testing.assert_allclose([r["proba"][c] for c in CLASSES], expect / expect.sum(),
                                   atol=1e-6)


@pytest.mark.parametrize("denoise", [False, True])
def test_predict_batch_equals_predict_clip(quint, denoise):
    """Mixed lengths in one batch (a 2 s clip puts the batch in the 49152
    bucket): each result equals predict_clip of its clip."""
    ours, _ = quint
    clips = _clips() + [(0.1 * np.random.RandomState(33).randn(32000)).astype(np.float32)]
    batch = ours.predict_batch(clips, denoise=denoise)
    assert len(batch) == 4
    for y, b in zip(clips, batch):
        solo = ours.predict_clip(y, denoise=denoise)
        assert solo["label"] == b["label"]
        assert _max_diff(solo["proba"], b["proba"]) < 1e-5
        for name in QUINT:
            assert _max_diff(solo["members"][name], b["members"][name]) < 1e-5


def test_warmup_runs_each_bucket_and_batch_size(quint):
    ours, _ = quint
    calls = []
    batch = type(ours).predict_batch

    def counted(self, clips, *a, **k):
        calls.append((len(clips[0]), len(clips)))
        return batch(self, clips, *a, **k)

    type(ours).predict_batch = counted
    try:
        ours.warmup(buckets=[24576, 49152], denoise=False, batch_sizes=(2, 3))
    finally:
        type(ours).predict_batch = batch
    assert calls == [(24576, 1), (24576, 2), (24576, 3), (49152, 1), (49152, 2), (49152, 3)]


@pytest.mark.parametrize("denoise", [False, True])
def test_ensemble_stream_matches_jax_across_segments(quint, denoise):
    """A small seg_samples makes the stream cross segments: identical window
    geometry, probabilities within 1e-4."""
    ours, theirs = quint
    y = (np.random.RandomState(34).randn(16000 * 5) * 0.2).astype(np.float32)
    kw = dict(window_s=1.0, hop_s=0.7, denoise=denoise, seg_samples=1 << 16)
    wins, ref = ours.predict_stream(y, **kw), theirs.predict_stream(y, **kw)
    assert len(wins) == len(ref) == 7
    for w, r in zip(wins, ref):
        assert (w["start_s"], w["end_s"]) == (r["start_s"], r["end_s"])
        assert _max_diff(w["proba"], r["proba"]) < 1e-4
        assert w["label"] == r["label"]


def test_stream_rejects_a_window_beyond_the_heads(quint):
    ours, _ = quint
    with pytest.raises(ValueError, match="t_max"):
        ours.predict_stream(np.zeros(16000 * 30, np.float32), window_s=12.0)


def test_votes_with_mlp_members_match_jax_and_stream_per_window(workspace):
    """MLP members (engine B's, the clean one, the raw+clean one) beside two
    heads: the vote matches the JAX package (host denoise for the MLPs), and
    the stream falls back to predict_batch over the windows."""
    weights = {"mlp": 0.2, "mlp_clean": 0.1, "mlp_both": 0.2, "cnn": 0.3, "cnn_bilstm": 0.2}
    ours, theirs = _pair(workspace, weights)
    for dn in (False, True):
        for y in _clips()[:2]:
            r, rj = ours.predict_clip(y, denoise=dn), theirs.predict_clip(y, denoise=dn)
            assert r["label"] == rj["label"]
            for name in weights:
                assert _max_diff(r["members"][name], rj["members"][name]) < (1e-3 if dn else 1e-4)
    y = (np.random.RandomState(35).randn(16000 * 3) * 0.2).astype(np.float32)
    kw = dict(window_s=1.0, hop_s=1.0, denoise=False, batch_size=2)
    wins, ref = ours.predict_stream(y, **kw), theirs.predict_stream(y, **kw)
    assert len(wins) == len(ref) == 3
    for w, r in zip(wins, ref):
        assert (w["start_s"], w["end_s"]) == (r["start_s"], r["end_s"])
        assert _max_diff(w["proba"], r["proba"]) < 1e-4


def test_load_skips_zero_weight_members_and_refuses_a_stale_class_order(workspace, tmp_path):
    from stutter_tpu_torch.infer import EnsemblePredictor

    ours, _ = _pair(workspace, {"cnn": 0.7, "cnn_bilstm": 0.3, "transformer": 0.0,
                                "mlp_both": 0.0})
    assert sorted(ours.members) == ["cnn", "cnn_bilstm"]
    r = ours.predict_clip(_clips()[0], denoise=False)
    assert sorted(r["members"]) == ["cnn", "cnn_bilstm"]
    with open(os.path.join(workspace, "ensemble.json"), "w") as f:
        json.dump({"weights": WEIGHTS, "classes": ["c", "b", "a"]}, f)
    with pytest.raises(ValueError, match="class order"):
        EnsemblePredictor.load(str(workspace), device="cpu")
    _write_ensemble(str(workspace), WEIGHTS)


@pytest.fixture(scope="module")
def mlp_pair(workspace):
    from stutter_tpu.config import PipelineConfig as JConfig
    from stutter_tpu.infer import Predictor as JPredictor
    from stutter_tpu_torch.infer import Predictor

    return Predictor.load(str(workspace), device="cpu"), JPredictor.load(str(workspace), JConfig())


@pytest.mark.parametrize("win,hop", [(16384, 8192), (16000, 11000)])
def test_mlp_stream_matches_jax_across_segments(mlp_pair, win, hop):
    """Predictor.predict_stream against the JAX one with a seg_samples that
    makes it cross segments; at frame-aligned starts each window equals
    predict_clip of its samples."""
    ours, theirs = mlp_pair
    y = (np.random.RandomState(36).randn(16000 * 6) * 0.2).astype(np.float32)
    kw = dict(window_s=win / 16000, hop_s=hop / 16000, seg_samples=2 * 16384)
    wins, ref = ours.predict_stream(y, **kw), theirs.predict_stream(y, **kw)
    assert len(wins) == len(ref) >= 6
    for w, r in zip(wins, ref):
        assert (w["start_s"], w["end_s"]) == (r["start_s"], r["end_s"])
        assert _max_diff(w["proba"], r["proba"]) < 1e-4 and w["label"] == r["label"]
    if hop % 512 == 0:
        for w in wins:
            s0 = int(round(w["start_s"] * 16000))
            solo = ours.predict_clip(y[s0 : s0 + win], denoise=False)
            assert _max_diff(w["proba"], solo["proba"]) < 1e-5
