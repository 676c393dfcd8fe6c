"""The port's data parallelism (stutter_tpu_torch/parallel/mesh.py and the
sharded entry points) on the CPU.

The port's mesh is make_mesh(devices=["cpu"] * 8): one device named eight
times, which runs the split, the per-shard launches and the gather in mesh
order.  The JAX side is stutter_tpu.parallel.mesh on the 8 virtual CPU
devices of tests/conftest.py.  Inputs come from numpy seeds; weights cross
with the converters (JAX-layout dicts, persist_seq_head).

Sharded against unsharded in the port is exact: the `one_thread` fixture
runs those tests on one CPU thread, because a multi-threaded CPU product
splits its reduction by the batch's size (a 149-dim row of the same clip
moves by ~1e-6 between a batch of 8 and a batch of 1, in the unsharded
path too)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stutter_tpu.parallel import mesh as J
from stutter_tpu_torch.parallel import mesh as M

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audio(seed, B, N, lengths):
    rng = np.random.RandomState(seed)
    t = np.arange(N) / 16000
    audio = (rng.randn(B, N) * 0.1).astype(np.float32)
    for b in range(B):
        audio[b] += (0.3 * np.sin(2 * np.pi * rng.uniform(150, 2000) * t)).astype(np.float32)
        audio[b, lengths[b]:] = 0
    return audio, np.asarray(lengths, np.int32)


def test_mesh_helpers():
    mesh = M.make_mesh(devices=CPU8)
    assert mesh == (torch.device("cpu"),) * 8
    assert M.resolve_mesh(None, "cpu") == (torch.device("cpu"),)
    assert M.resolve_mesh(["cpu", "cpu"], "cuda") == (torch.device("cpu"),) * 2
    assert [s for _, s in M.grid_shards(6, mesh)] == [slice(i, i + 1) for i in range(6)]
    assert [s for _, s in M.grid_shards(40, mesh)] == [slice(5 * i, 5 * i + 5) for i in range(8)]
    assert [s for _, s in M.grid_shards(7, mesh[:4])] == [slice(0, 7)]
    xs, ys = M.shard_batch(mesh[:4], np.arange(8.0), np.arange(8))
    assert [x.tolist() for x in xs] == [[0, 1], [2, 3], [4, 5], [6, 7]] and len(ys) == 4
    with pytest.raises(ValueError, match="does not divide"):
        M.shard_batch(mesh, np.zeros(12))
    lin = torch.nn.Linear(2, 2)
    assert all(m is lin for m in M.replicate(mesh[:2], lin))
    reps = M.replicate(mesh[:3], {"w": np.ones(2, np.float32)})
    assert len(reps) == 3 and all(torch.equal(r["w"], torch.ones(2)) for r in reps)
    with pytest.raises(ValueError, match="at least one"):
        M.make_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            M.make_mesh()


def test_extract_features_sharded_matches_jax(one_thread):
    """[8, 149] against the JAX package's sharded extractor: the MFCC block
    within 2e-3, chroma within 1e-5 (the bounds of test_torch_slice.py);
    the port's shards equal its unsharded batch exactly."""
    from stutter_tpu_torch.ops.frontend import extract_features_149_batch

    audio, lengths = _audio(1, 8, 24576, [24000, 20000, 24576, 16000, 9000, 24000, 12288, 3000])
    ours = M.extract_features_sharded(M.make_mesh(devices=CPU8), audio, lengths)
    theirs = np.asarray(J.extract_features_sharded(J.make_mesh(8), audio, lengths))
    assert ours.shape == theirs.shape == (8, 149)
    assert np.abs(ours[:, :120] - theirs[:, :120]).max() < 2e-3
    assert np.abs(ours[:, 120:144] - theirs[:, 120:144]).max() < 1e-5
    whole = extract_features_149_batch(torch.from_numpy(audio), torch.from_numpy(lengths))
    np.testing.assert_array_equal(ours, whole.numpy())


def test_denoise_sharded_matches_jax(one_thread):
    from stutter_tpu_torch.denoise import denoise_batch

    audio, lengths = _audio(2, 8, 8192, [8192, 6000, 8000, 4096, 8192, 5000, 7777, 8192])
    ours = M.denoise_sharded(M.make_mesh(devices=CPU8), audio, lengths)
    theirs = np.asarray(J.denoise_sharded(J.make_mesh(8), audio, lengths))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=5e-5)
    whole = denoise_batch(torch.from_numpy(audio), torch.from_numpy(lengths))
    np.testing.assert_array_equal(ours, whole.numpy())


def _jax_mlp(seed, d_in, hidden):
    from stutter_tpu.models.mlp import init_mlp

    return init_mlp(jax.random.PRNGKey(seed), d_in, hidden, 3)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_dp_train_step_matches_jax(opt):
    """Three data-parallel steps on 8 devices, SGD at 0.1 or Adam at 1e-2,
    from the same weights and batches: every weight and each step's loss
    within 1e-5 of the JAX package's."""
    rng = np.random.RandomState(3)
    init = _jax_mlp(0, 20, (16,))
    jopt = optax.sgd(0.1) if opt == "sgd" else optax.adam(1e-2)
    jmesh, mesh = J.make_mesh(8), M.make_mesh(devices=CPU8)
    jstep = J.make_dp_train_step(jmesh, jopt, n_classes=3)
    jparams, jstate = J.replicate(jmesh, init), J.replicate(jmesh, jopt.init(init))
    step = M.make_dp_train_step(
        mesh, (lambda ps: torch.optim.SGD(ps, lr=0.1)) if opt == "sgd"
        else (lambda ps: torch.optim.Adam(ps, lr=1e-2)), n_classes=3)
    params = M.replicate(mesh, {k: np.asarray(v) for k, v in init.items()})
    for _ in range(3):
        X = rng.randn(32, 20).astype(np.float32)
        y = rng.randint(0, 3, 32).astype(np.int32)
        jparams, jstate, jloss = jstep(jparams, jstate, *J.shard_batch(jmesh, jnp.asarray(X),
                                                                       jnp.asarray(y)))
        params, loss = step(params, *M.shard_batch(mesh, X, y))
        assert abs(float(loss) - float(jloss)) < 1e-5
    assert len(params) == 8
    for k in init:
        for rep in params:
            np.testing.assert_allclose(rep[k].detach().numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=1e-5)


def test_dp_eval_accuracy_matches_jax():
    rng = np.random.RandomState(4)
    init = _jax_mlp(1, 10, (8,))
    X = rng.randn(24, 10).astype(np.float32)
    y = rng.randint(0, 3, 24)
    theirs = J.dp_eval_accuracy(J.make_mesh(8), J.replicate(J.make_mesh(8), init), X, y)
    mesh = M.make_mesh(devices=CPU8)
    ours = M.dp_eval_accuracy(mesh, M.replicate(mesh, {k: np.asarray(v) for k, v in init.items()}),
                              X, y)
    assert ours == theirs and 0.0 < ours < 1.0


def test_train_mlp_dp_matches_jax():
    """Two epochs (8 steps of 16 rows) of the JAX package's train_mlp_dp
    from its own init, carried to the port by init=: weights within 1e-4."""
    rng = np.random.RandomState(5)
    X = rng.randn(64, 12).astype(np.float32)
    y = ((X[:, 0] > 0).astype(np.int32) + (X[:, 1] > 0)).astype(np.int32)
    kw = dict(n_classes=3, epochs=2, batch_size=16, learning_rate=1e-2, seed=7, hidden=(16,))
    theirs = J.train_mlp_dp(J.make_mesh(8), X, y, **kw)
    ours = M.train_mlp_dp(M.make_mesh(devices=CPU8), X, y, **kw,
                          init={k: np.asarray(v) for k, v in _jax_mlp(7, 12, (16,)).items()})
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=0, atol=1e-4)


def test_ensemble_sharded_matches_jax(tmp_path, one_thread):
    """A cnn and a transformer (the JAX package's inits) through the whole
    request path on 8 devices, 8 x 8192 samples, lengths 8000: [2, 8, 3]
    within 1e-4 of the JAX package's ensemble_sharded; the port's shards
    within 1e-6 of its unsharded fused path (infer._ensemble_fused): the
    heads' CPU convolutions and products pick their kernels by the batch's
    size, even on one thread (measured 1.5e-7)."""
    from stutter_tpu.config import DenoiseConfig as JDenoise
    from stutter_tpu.models.cnn import init_cnn
    from stutter_tpu.models.transformer import init_transformer
    from stutter_tpu.train.seq_pipeline import ARCHS as JARCHS
    from stutter_tpu_torch.config import DenoiseConfig
    from stutter_tpu_torch.infer import SeqPredictor, _ensemble_fused, _member_groups
    from stutter_tpu_torch.train.seq_pipeline import persist_seq_head

    audio, lengths = _audio(6, 8, 8192, [8000] * 8)
    params = (init_cnn(jax.random.PRNGKey(0), n_mels=128, n_classes=3),
              init_transformer(jax.random.PRNGKey(1), n_mels=128, n_classes=3))
    norms = tuple((jnp.zeros(128, jnp.float32), jnp.ones(128, jnp.float32)) for _ in range(2))
    archs = ("cnn", "transformer")
    specs = tuple((JARCHS[a]["kind"], JARCHS[a]["apply_fn"]) for a in archs)
    theirs = np.asarray(J.ensemble_sharded(J.make_mesh(8), audio, lengths, params, norms,
                                           specs=specs, dn_cfg=JDenoise(), denoise=True))

    members = []
    for arch, p in zip(archs, params):
        persist_seq_head(str(tmp_path), arch, jax.tree.map(np.asarray, p),
                         np.zeros(128, np.float32), np.ones(128, np.float32), ["a", "b", "c"])
        members.append(SeqPredictor.load(str(tmp_path), arch, device="cpu"))
    ours = M.ensemble_sharded(M.make_mesh(devices=CPU8), audio, lengths, members)
    assert ours.shape == theirs.shape == (2, 8, 3)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)
    whole = _ensemble_fused(torch.from_numpy(audio), torch.from_numpy(lengths), lengths,
                            _member_groups(members), 2, DenoiseConfig(), True, 16000)
    np.testing.assert_allclose(ours, whole.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_run_bucketed_sharded_equals_unsharded(one_thread, n_dev):
    """The request mix's buckets, each batch padded to the mesh's multiple
    with zero-length rows and cut over it: the features of the unsharded
    run, exactly, in the clips' order."""
    from stutter_tpu_torch.config import FEATURES_149
    from stutter_tpu_torch.ops.frontend import extract_features_numpy, run_bucketed

    rng = np.random.RandomState(8)
    clips = [(rng.randn(int(s * 16000)) * 0.1).astype(np.float32)
             for s in (1.5, 3, 3, 0.2, 3, 5, 1.2, 0.9)]
    whole = extract_features_numpy(clips, FEATURES_149, batch_size=4, device="cpu")
    ours = extract_features_numpy(clips, FEATURES_149, batch_size=4, device="cpu",
                                  mesh=["cpu"] * n_dev)
    np.testing.assert_array_equal(ours, whole)
    assert (np.abs(whole[[0, 1, 5]]).sum(-1) > 0).all() and (whole[3] == 0).all()
    lens = run_bucketed(clips, lambda a, n: n[:, None].float(), 1, batch_size=3, device="cpu",
                        mesh=["cpu"] * n_dev)
    np.testing.assert_array_equal(lens[:, 0], [len(c) for c in clips])


def _mlp_data(seed, n=60, d=12):
    from stutter_tpu_torch.train.splits import stratified_kfold

    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = ((X[:, 0] > 0).astype(np.int64) + (X[:, 1] > 0)).astype(np.int64)
    return X, y, stratified_kfold(y, 3, seed=42)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_cross_validate_mlp_sharded_equals_unsharded(one_thread, n_dev):
    """3 folds x 2 seeds, dropout on: the grid over 2 devices (3 entries
    each) or 8 (6 of them, one entry each) gives the unsharded run's
    probabilities and predictions exactly; so does fit_mlp's seed grid."""
    from stutter_tpu_torch.train.trainer import MLPTrainConfig, cross_validate_mlp, fit_mlp

    X, y, folds = _mlp_data(9)
    cfg = MLPTrainConfig(hidden=(16, 8), n_classes=3, epochs=60, batch_size=16, n_seeds=2,
                         learning_rate=1e-2)
    pred_u, proba_u = cross_validate_mlp(X, y, folds, cfg, device="cpu")
    pred_s, proba_s = cross_validate_mlp(X, y, folds, cfg, device="cpu", mesh=["cpu"] * n_dev)
    np.testing.assert_array_equal(proba_s, proba_u)
    np.testing.assert_array_equal(pred_s, pred_u)
    assert (pred_u == y).mean() > 0.5
    fit_u = fit_mlp(X, y, cfg, device="cpu").to_jax_params()
    fit_s = fit_mlp(X, y, cfg, device="cpu", mesh=["cpu"] * n_dev).to_jax_params()
    for k in fit_u:
        np.testing.assert_array_equal(fit_s[k], fit_u[k])


def test_cross_validate_seq_sharded_equals_unsharded(monkeypatch, one_thread):
    """The cnn at narrow widths, 3 folds x 2 seeds, 2 epochs with mixup and
    SpecAugment: grid_chunk 2 over a mesh of 3 (one chunk of 6, two
    entries a device, in lockstep) gives the unsharded run's probabilities
    (three chunks of 2) exactly."""
    from stutter_tpu_torch.train import seq_pipeline as P
    from stutter_tpu_torch.train.seq_trainer import SeqTrainConfig

    rng = np.random.RandomState(10)
    n, n_t, D, C = 18, 16, 128, 2
    X = rng.randn(n, n_t, D).astype(np.float32)
    y = np.arange(n) % C
    X += y[:, None, None] * 0.5
    nv = rng.randint(5, n_t + 1, n).astype(np.int32)
    monkeypatch.setattr(P, "prepare_sequence_dataset", lambda c, kind, device: (X, nv))
    monkeypatch.setitem(P.ARCHS, "cnn", {**P.ARCHS["cnn"], "init_kwargs":
                                         lambda c: {"n_mels": 128, "n_classes": c,
                                                    "channels": (4,)}})
    folds = [(np.setdiff1d(np.arange(n), np.arange(k, n, 3)), np.arange(k, n, 3))
             for k in range(3)]
    tc = SeqTrainConfig(epochs=2, batch_size=4, mixup_alpha=0.2, time_masks=1, time_width=3,
                        freq_masks=1, freq_width=4)
    out = [P.cross_validate_seq("cnn", [None] * n, y, folds, C, tc, n_seeds=2, grid_chunk=2,
                                device="cpu", mesh=mesh)[1] for mesh in (None, ["cpu"] * 3)]
    np.testing.assert_array_equal(out[1], out[0])
    np.testing.assert_allclose(out[0].sum(-1), 1.0, atol=1e-5)
