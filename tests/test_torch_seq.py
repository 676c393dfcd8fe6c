"""The port's sequence heads, featurizer and SeqPredictor against the JAX
package on the CPU: the same weights (the JAX init, perturbed so that no
bias or gain is trivial) and the same numpy-seeded inputs."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CLASSES = ["a", "b", "c"]
N = 24576  # the smallest clip bucket


def _perturbed(params, seed, scale=0.1):
    rng = np.random.RandomState(seed)
    return {k: (np.asarray(v) + scale * rng.randn(*np.shape(v))).astype(np.float32)
            for k, v in params.items()}


def _jax_params(arch, seed, n_classes=3):
    from stutter_tpu.train.seq_pipeline import ARCHS

    spec = ARCHS[arch]
    return _perturbed(spec["init_fn"](jax.random.PRNGKey(seed), **spec["init_kwargs"](n_classes)),
                      seed + 100)


def _jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def heads():
    """JAX weights of each architecture, and the port's modules from them."""
    from stutter_tpu_torch.train.seq_pipeline import ARCHS

    out = {}
    for seed, arch in enumerate(("cnn", "cnn_bilstm", "transformer")):
        p = _jax_params(arch, seed)
        out[arch] = (p, ARCHS[arch]["module"].from_jax_params(p, device="cpu"))
    return out


def _inputs(T, D, seed):
    rng = np.random.RandomState(seed)
    nv = np.array([T, T - 37, 9, 1])  # unequal prefix masks, down to one frame
    return rng.randn(4, T, D).astype(np.float32), np.arange(T)[None] < nv[:, None], nv


@pytest.mark.parametrize("T", [316, 157])
@pytest.mark.parametrize("arch", ["cnn", "cnn_bilstm", "transformer"])
def test_head_logits_match_jax(heads, arch, T):
    """Logits within 1e-4 at the trained frame count and at an odd one
    (XLA's 'SAME' padding differs between the two)."""
    from stutter_tpu.train.seq_pipeline import ARCHS as JARCHS

    params, model = heads[arch]
    x, mask, nv = _inputs(T, 60 if arch == "cnn_bilstm" else 128, T)
    ref = np.asarray(JARCHS[arch]["apply_fn"](_jax(params), jnp.asarray(x), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask), nv).numpy()
    assert got.shape == ref.shape == (4, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_bilstm_hidden_states_equal_the_scan_at_valid_steps(heads):
    """The packed torch.nn.LSTM's hidden states, forward and backward, at
    every valid step of a batch with unequal lengths == _lstm_scan's."""
    from stutter_tpu.models.cnn_bilstm import _lstm_scan

    params, model = heads["cnn_bilstm"]
    x, mask, nv = _inputs(79, 96, 5)
    jp = _jax(params)
    fwd = _lstm_scan(jp["lstm_fwd_wx"], jp["lstm_fwd_wh"], jp["lstm_fwd_b"], jnp.asarray(x),
                     jnp.asarray(mask))
    bwd = _lstm_scan(jp["lstm_bwd_wx"], jp["lstm_bwd_wh"], jp["lstm_bwd_b"],
                     jnp.asarray(x[:, ::-1]), jnp.asarray(mask[:, ::-1]))[:, ::-1]
    ref = np.concatenate([np.asarray(fwd), np.asarray(bwd)], axis=-1)
    with torch.no_grad():
        got = model.hidden_states(torch.from_numpy(x), nv).numpy()
    np.testing.assert_allclose(got[mask], ref[mask], rtol=0, atol=1e-5)
    assert not got[~mask].any()


def test_stacked_transformers_equal_each_member_alone():
    from stutter_tpu_torch.models.transformer import Transformer

    ps = [_jax_params("transformer", s) for s in (3, 4, 5)]
    alone = [Transformer.from_jax_params(p, device="cpu") for p in ps]
    stacked = Transformer.stack(alone)
    assert stacked.n_members == 3
    for m, p in enumerate(ps):
        back = stacked.to_jax_params(m)
        assert all(np.array_equal(back[k], v) for k, v in p.items())
    rng = np.random.RandomState(6)
    x = rng.randn(3, 2, 316, 128).astype(np.float32)  # each member's own input
    mask = torch.from_numpy(np.arange(316)[None] < np.array([[316], [200]]))
    with torch.no_grad():
        got = stacked(torch.from_numpy(x), mask)
        for m in range(3):
            one = alone[m](torch.from_numpy(x[m]), mask)
            np.testing.assert_allclose(got[m].numpy(), one.numpy(), rtol=0, atol=1e-5)
    assert not np.allclose(got[0].numpy(), got[1].numpy(), atol=1e-3)


@pytest.mark.parametrize("arch", ["cnn", "cnn_bilstm", "transformer"])
def test_params_round_trip_in_the_jax_layout(heads, arch):
    params, model = heads[arch]
    back = model.to_jax_params()
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)


def test_bilstm_exports_its_weights_after_an_optimizer_step():
    """The LSTM's weights are kept once (in nn.LSTM): after one optimizer
    step on a requires_grad copy, the export moved, and the JAX
    apply_cnn_bilstm on it equals the port's forward within 1e-4."""
    from stutter_tpu.models.cnn_bilstm import apply_cnn_bilstm
    from stutter_tpu_torch.models.cnn_bilstm import CNNBiLSTM

    params = _jax_params("cnn_bilstm", 12)
    model = CNNBiLSTM.from_jax_params(params, device="cpu").requires_grad_(True)
    assert not any(k.startswith("lstm_") for k in model.p)
    x, mask, nv = _inputs(96, 60, 13)
    x, mask_t = torch.from_numpy(x), torch.from_numpy(mask)
    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    model(x, mask_t, nv).square().sum().backward()
    opt.step()
    back = model.to_jax_params()
    assert sorted(back) == sorted(params)
    for k in ("lstm_fwd_wx", "lstm_bwd_wh", "lstm_fwd_b", "conv0", "w_out"):
        assert np.abs(back[k] - params[k]).max() > 1e-3, k  # the step reached the export
    with torch.no_grad():
        got = model(x, mask_t, nv).numpy()
    ref = np.asarray(apply_cnn_bilstm(_jax(back), jnp.asarray(x.numpy()), jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def _clips():
    rng = np.random.RandomState(11)
    t = np.arange(N) / 16000
    return [(0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(N)).astype(np.float32),
            (0.2 * rng.randn(20000)).astype(np.float32),
            (0.4 * np.sin(2 * np.pi * 900 * t[:7001]) * (t[:7001] % 0.2 < 0.1)
             + 0.02 * rng.randn(7001)).astype(np.float32)]


@pytest.mark.parametrize("kind", ["logmel", "mfcc_deltas"])
def test_featurize_seq_matches_jax(kind):
    """Linear mel within 1e-4 of its max (the mel mode's bound), then the
    features: log-mel and the MFCC stack within 2e-3 at valid frames."""
    from stutter_tpu.ops import filterbanks as jfb
    from stutter_tpu.ops.spectral import power_spectrogram
    from stutter_tpu.train.seq_trainer import _featurize_seq as jfeat
    from stutter_tpu_torch.ops.spectromel import spectromel
    from stutter_tpu_torch.train.seq_trainer import _featurize_seq

    clips = _clips()
    audio = np.zeros((3, N), np.float32)
    lens = np.array([len(c) for c in clips], np.int32)
    for i, c in enumerate(clips):
        audio[i, : len(c)] = c
    a, le = torch.from_numpy(audio), torch.from_numpy(lens)
    fj, mj = jfeat(jnp.asarray(audio), jnp.asarray(lens), kind, 16000)
    ft, mt = _featurize_seq(a, le, kind)
    mask = np.asarray(mj)
    assert np.array_equal(mask, mt.numpy()) and ft.shape == fj.shape
    assert np.abs(ft.numpy() - np.asarray(fj))[mask].max() < 2e-3
    power = np.asarray(power_spectrogram(jnp.asarray(audio), 2048, 512)) * mask[:, :, None]
    mel_ref = power @ jfb.mel_fb(16000, 2048, 128).T
    _, mel, tb = spectromel(a, le, with_stats=False, with_tuning=False)
    assert tb is None
    assert np.abs(mel.numpy() - mel_ref).max() / mel_ref.max() < 1e-4


def test_with_tuning_only_drops_the_tuning_bin():
    from stutter_tpu_torch.ops.spectromel import spectromel

    clips = _clips()
    a = torch.zeros(2, N)
    a[0], a[1, :20000] = torch.from_numpy(clips[0]), torch.from_numpy(clips[1])
    le = torch.tensor([N, 20000], dtype=torch.int32)
    p, m, tb = spectromel(a, le, with_stats=False)
    p2, m2, tb2 = spectromel(a, le, with_stats=False, with_tuning=False)
    assert torch.equal(p, p2) and torch.equal(m, m2) and tb.shape == (2,) and tb2 is None
    with pytest.raises(ValueError, match="with_tuning"):
        spectromel(a, le, with_tuning=False)


def _bucket_loop_dataset(clips, kind, batch, t_max=316, sr=16000):
    """prepare_sequence_dataset as a loop of its own: each bucket's clips
    in input order, in chunks of `batch`, zero-padded into a fresh batch,
    featurized, and each clip's frames cut to its own count."""
    from stutter_tpu_torch.ops.frontend import DEFAULT_BUCKETS, pad_to_bucket
    from stutter_tpu_torch.train.seq_trainer import FEATURE_DIMS, _featurize_seq

    out = np.zeros((len(clips), t_max, FEATURE_DIMS[kind]), np.float32)
    n_valid = np.zeros(len(clips), np.int32)
    by_bucket: dict[int, list[int]] = {}
    for i, y in enumerate(clips):
        by_bucket.setdefault(pad_to_bucket(len(y), DEFAULT_BUCKETS), []).append(i)
    for bucket, idxs in by_bucket.items():
        for s in range(0, len(idxs), batch):
            chunk = idxs[s : s + batch]
            buf = np.zeros((len(chunk), bucket), np.float32)
            lens = np.zeros(len(chunk), np.int32)
            for j, i in enumerate(chunk):
                y = clips[i][:bucket]
                buf[j, : len(y)] = y
                lens[j] = len(y)
            with torch.no_grad():
                feats, _ = _featurize_seq(torch.from_numpy(buf), torch.from_numpy(lens), kind, sr)
            feats = feats.numpy()
            for j, i in enumerate(chunk):
                t = min(1 + int(lens[j]) // 512, t_max)
                out[i, :t] = feats[j, :t]
                n_valid[i] = t
    return out, n_valid


@pytest.mark.parametrize("kind", ["logmel", "mfcc_deltas"])
def test_prepare_sequence_dataset_is_its_bucket_loop(kind):
    """The featurizer through the one host batch loop equals, bit for bit,
    the same batches padded into fresh zeros: a clip past the largest
    bucket (cut to it), one of a few samples, and batches of 2 that split
    the smallest bucket's four clips."""
    from stutter_tpu_torch.train.seq_trainer import prepare_sequence_dataset

    rng = np.random.RandomState(12)
    clips = [(0.1 * rng.randn(n)).astype(np.float32)
             for n in (9000, 170000, 30000, 12000, 20000, 160000, 50000, 401)]
    X, nv = prepare_sequence_dataset(clips, kind, batch=2, device="cpu")
    want_X, want_nv = _bucket_loop_dataset(clips, kind, 2)
    assert X.dtype == want_X.dtype and np.array_equal(X, want_X)
    assert nv.dtype == want_nv.dtype and np.array_equal(nv, want_nv)
    assert nv[1] == 316 and nv[7] == 1


def test_prepare_and_predict_sequence_dataset_match_jax():
    from stutter_tpu.train import seq_trainer as J
    from stutter_tpu_torch.train import seq_trainer as P
    from stutter_tpu_torch.train.seq_pipeline import ARCHS

    clips = _clips() + [np.zeros(170000, np.float32) + 0.01]  # cut to the 10 s bucket
    X, nv = P.prepare_sequence_dataset(clips, "logmel", device="cpu")
    Xj, nvj = J.prepare_sequence_dataset(clips, "logmel")
    assert np.array_equal(nv, nvj) and X.shape == Xj.shape == (4, 316, 128) and nv[-1] == 316
    assert np.abs(X - Xj).max() < 2e-3
    Xs, mean, std = P.standardize_sequences(X, nv)
    Xsj, meanj, stdj = J.standardize_sequences(X, nv)
    np.testing.assert_array_equal(Xs, Xsj)
    params = _jax_params("cnn", 7)
    got = P.predict_sequence_model(ARCHS["cnn"]["module"].from_jax_params(params, device="cpu"),
                                   Xs, nv, batch=3, device="cpu")
    from stutter_tpu.train.seq_pipeline import ARCHS as JARCHS

    ref = J.predict_sequence_model(JARCHS["cnn"]["apply_fn"], _jax(params), Xs, nv)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A head of each architecture written by the JAX package's
    persist_seq_head, with nonzero normalization stats."""
    from stutter_tpu.train.seq_pipeline import persist_seq_head

    out = tmp_path_factory.mktemp("seq")
    rng = np.random.RandomState(12)
    for seed, arch in enumerate(("cnn", "cnn_bilstm", "transformer_lr1e3")):
        D = 60 if arch == "cnn_bilstm" else 128
        persist_seq_head(str(out), arch, _jax_params(arch, 20 + seed),
                         (rng.randn(D) - (30 if D == 128 else 0)).astype(np.float32),
                         (1 + 10 * rng.rand(D)).astype(np.float32), CLASSES)
    return out


@pytest.mark.parametrize("denoise", [False, True])
@pytest.mark.parametrize("arch", ["cnn", "cnn_bilstm", "transformer_lr1e3"])
def test_seq_predictor_matches_jax(workspace, arch, denoise):
    """The port's SeqPredictor on artifacts the JAX package wrote: the same
    label, probabilities within 1e-4 (1e-3 with the gate on)."""
    from stutter_tpu.config import PipelineConfig as JConfig
    from stutter_tpu.infer import SeqPredictor as JSeq
    from stutter_tpu_torch.infer import SeqPredictor

    ours = SeqPredictor.load(str(workspace), arch, device="cpu")
    theirs = JSeq.load(str(workspace), arch, JConfig())
    assert ours.kind == theirs.kind and ours.classes_ == CLASSES
    for y in _clips():
        r, rj = ours.predict_clip(y, denoise=denoise), theirs.predict_clip(y, denoise=denoise)
        assert r["label"] == rj["label"]
        assert max(abs(r["proba"][c] - rj["proba"][c]) for c in CLASSES) < (
            1e-3 if denoise else 1e-4)


def test_persist_seq_head_writes_what_the_jax_package_reads(tmp_path):
    from stutter_tpu.infer import SeqPredictor as JSeq
    from stutter_tpu_torch import persist
    from stutter_tpu_torch.infer import SeqPredictor
    from stutter_tpu_torch.train.seq_pipeline import persist_seq_head

    params = _jax_params("cnn_bilstm", 9)
    mean, std = np.zeros(60, np.float32), np.ones(60, np.float32)
    persist_seq_head(str(tmp_path), "cnn_bilstm", params, mean, std, CLASSES)
    meta = json.loads((tmp_path / "model_cnn_bilstm.json").read_text())
    assert meta == {"arch": "cnn_bilstm", "classes": CLASSES, "kind": "mfcc_deltas"}
    theirs = JSeq.load(str(tmp_path), "cnn_bilstm")
    ours = SeqPredictor.load(str(tmp_path), "cnn_bilstm", device="cpu")
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(theirs.params[k]), v)
        np.testing.assert_array_equal(ours.model.to_jax_params()[k], v)
    assert persist._unflatten_params(persist._flatten_params({"a": {"b": mean}}))["a"]["b"] is not None
    y = _clips()[1]
    r, rj = ours.predict_clip(y, denoise=False), theirs.predict_clip(y, denoise=False)
    assert max(abs(r["proba"][c] - rj["proba"][c]) for c in CLASSES) < 1e-4
