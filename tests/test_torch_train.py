"""The port's MLP trainer (stutter_tpu_torch.train.trainer), its permutation
importance and its saved models against the JAX package on the CPU, at
small widths (hidden (16, 8), D = 12, G = 3).

The two packages draw from different generators, so the tests hold the
parts and the outcome: the schedule, the loss and fed optimizer steps
(the same batch rows and the JAX dropout masks, rebuilt from its rng as
apply_mlp splits it) against optax's chain; the grid against its entries
trained alone; the sampler; accuracy on separable features; importance on
the same weights; and a saved model read by the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stutter_tpu.train import trainer as JT
from stutter_tpu_torch.train import trainer as T

torch.set_num_threads(2)

HIDDEN, D, C = (16, 8), 12, 3
CFG = T.MLPTrainConfig(hidden=HIDDEN, n_classes=C, epochs=4, batch_size=16, n_seeds=3)
JCFG = JT.MLPTrainConfig(hidden=HIDDEN, n_classes=C, epochs=4, batch_size=16, n_seeds=3)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _data(seed, n=40):
    rng = np.random.RandomState(seed)
    return rng.randn(n, D).astype(np.float32), rng.randint(0, C, n).astype(np.int32)


def _jax_keeps(key, batch, p=CFG.dropout):
    """apply_mlp's keep-masks for `key`: one split per hidden layer."""
    keeps = []
    for h in HIDDEN:
        key, sub = jax.random.split(key)
        keeps.append(np.asarray(jax.random.bernoulli(sub, 1.0 - p, (batch, h))))
    return keeps


def _feeds(n_steps, G, n, seed=5):
    """Per step and grid entry: batch row indices and a JAX dropout key."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, n, size=(n_steps, G, CFG.batch_size))
    keys = [[jax.random.PRNGKey(1000 * t + g) for g in range(G)] for t in range(n_steps)]
    return idx, keys


def _torch_batch(X, y, idx_t, keys_t):
    """The step's batch as GridTrainer.step takes it, G entries stacked."""
    xb = torch.from_numpy(np.stack([X[i] for i in idx_t]))
    yb = torch.from_numpy(np.stack([y[i] for i in idx_t]).astype(np.int64))
    wb = torch.ones(len(idx_t), CFG.batch_size)
    per = [_jax_keeps(k, CFG.batch_size) for k in keys_t]
    keeps = [torch.from_numpy(np.stack([p[l] for p in per])) for l in range(len(HIDDEN))]
    return xb, yb, wb, keeps


def _jax_params(seed):
    from stutter_tpu_torch.models.mlp import init_mlp

    return {k: jnp.asarray(v) for k, v in init_mlp(seed, D, HIDDEN, C).items()}


def test_init_mlp_draws_he_scaled_weights_from_a_numpy_seed():
    from stutter_tpu_torch.models.mlp import init_mlp

    a, b = init_mlp(7, D, HIDDEN, C), init_mlp(7, D, HIDDEN, C)
    assert sorted(a) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    rng = np.random.RandomState(7)
    np.testing.assert_array_equal(a["w0"], (rng.randn(D, 16) * np.sqrt(2.0 / D)).astype(np.float32))
    assert all(np.array_equal(a[k], b[k]) for k in a) and not a["b1"].any()
    assert a["w2"].shape == (8, C)


def test_learning_rate_equals_optax_cosine_schedule_at_every_step_of_a_run():
    """The rate each step of a GridTrainer run used, and the formula past
    the end, equal cosine_decay_schedule(alpha=0.01) within 1e-6.  The
    schedule is read in float64: in float32 its 1 + cos(pi t / T) cancels
    near the end, and the float32 value is itself 1.1e-6 off there."""
    n_steps = 37
    schedule = optax.cosine_decay_schedule(CFG.learning_rate, n_steps, alpha=0.01)

    def sched(t):
        with jax.enable_x64(True):
            return float(schedule(t))

    X, y = _data(0)
    tr = T.GridTrainer(T.init_grid([1], D, CFG, "cpu"), CFG, n_steps)
    gen = torch.Generator().manual_seed(0)
    Xg, yg, wg = (torch.from_numpy(X)[None], torch.from_numpy(y.astype(np.int64))[None],
                  torch.ones(1, len(y)))
    used = []
    for _ in range(n_steps):
        tr.step(*T.draw_batch(Xg, yg, wg, CFG, gen))
        used.append(tr.opt.param_groups[0]["lr"])
    ref = [float(sched(t)) for t in range(n_steps)]
    np.testing.assert_allclose(used, ref, rtol=1e-6)
    assert used[0] == CFG.learning_rate
    for t in (n_steps, n_steps + 5):
        assert abs(T.learning_rate(t, n_steps, CFG) / float(sched(t)) - 1) < 1e-6
    assert abs(T.learning_rate(n_steps, n_steps, CFG) - 0.01 * CFG.learning_rate) < 1e-12


def test_loss_equals_the_jax_loss_on_the_same_weights_batch_and_masks():
    X, y = _data(1)
    idx, keys = _feeds(1, 3, len(y))
    rng = np.random.RandomState(2)
    w = (rng.rand(3, CFG.batch_size) > 0.3).astype(np.float32)  # a partial sample mask
    params = [_jax_params(s) for s in (10, 11, 12)]
    grid = {k: torch.from_numpy(np.stack([np.asarray(p[k]) for p in params])) for k in params[0]}
    xb, yb, _, keeps = _torch_batch(X, y, idx[0], keys[0])
    n = len(grid) // 2
    got = T.grid_losses([grid[f"w{i}"] for i in range(n)], [grid[f"b{i}"] for i in range(n)],
                        xb, yb, torch.from_numpy(w), keeps, CFG).numpy()
    for g in range(3):
        ref = float(JT._loss_fn(params[g], jnp.asarray(X[idx[0, g]]), jnp.asarray(y[idx[0, g]]),
                                jnp.asarray(w[g]), keys[0][g], JCFG))
        assert abs(got[g] - ref) < 1e-6, (g, got[g], ref)


def _optax_steps(params, X, y, idx, keys, n_steps, total):
    sched = optax.cosine_decay_schedule(JCFG.learning_rate, total, alpha=0.01)
    opt = optax.chain(optax.add_decayed_weights(JCFG.weight_decay), optax.adam(sched))
    state = opt.init(params)
    w = jnp.ones(JCFG.batch_size)
    for t in range(n_steps):
        grads = jax.grad(JT._loss_fn)(params, jnp.asarray(X[idx[t]]), jnp.asarray(y[idx[t]]), w,
                                      keys[t], JCFG)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return params


@pytest.mark.parametrize("n_steps", [1, 5])
def test_fed_steps_equal_optax_chain(n_steps):
    """1 and 5 steps of the grid (G = 3), each entry's batch rows and
    dropout masks fed, equal optax.chain(add_decayed_weights, adam(cosine))
    on each entry within 1e-5 relative."""
    X, y = _data(3)
    total = 20
    idx, keys = _feeds(n_steps, 3, len(y))
    seeds = (20, 21, 22)
    tr = T.GridTrainer(T.init_grid(seeds, D, CFG, "cpu"), CFG, total)
    for t in range(n_steps):
        tr.step(*_torch_batch(X, y, idx[t], keys[t]))
    got = tr.params()
    for g, s in enumerate(seeds):
        ref = _optax_steps(_jax_params(s), X, y, idx[:, g], [k[g] for k in keys], n_steps, total)
        for k, v in ref.items():
            assert _rel(got[k][g].numpy(), v) < 1e-5, (n_steps, g, k, _rel(got[k][g].numpy(), v))
            assert not np.array_equal(got[k][g].numpy(), np.asarray(_jax_params(s)[k]))


def test_grid_trains_each_entry_as_if_alone():
    """Three entries trained together equal each trained alone on the same
    feeds: the grid's losses are summed, not averaged (a mean would scale
    each gradient by 1/3 against the weight decay)."""
    X, y = _data(4)
    n_steps, total = 6, 12
    idx, keys = _feeds(n_steps, 3, len(y), seed=6)
    seeds = (30, 31, 32)
    grid = T.GridTrainer(T.init_grid(seeds, D, CFG, "cpu"), CFG, total)
    alone = [T.GridTrainer(T.init_grid([s], D, CFG, "cpu"), CFG, total) for s in seeds]
    for t in range(n_steps):
        xb, yb, wb, keeps = _torch_batch(X, y, idx[t], keys[t])
        grid.step(xb, yb, wb, keeps)
        for g, tr in enumerate(alone):
            tr.step(xb[g : g + 1], yb[g : g + 1], wb[g : g + 1], [k[g : g + 1] for k in keeps])
    for g, tr in enumerate(alone):
        for k, v in tr.params().items():
            np.testing.assert_allclose(grid.params()[k][g].numpy(), v[0].numpy(),
                                       rtol=1e-6, atol=1e-7)


def test_sampler_never_draws_a_padded_row():
    """Rows of w = 0 (a fold's padding) are never drawn; every valid row is."""
    G, N = 4, 30
    n_valid = [30, 24, 17, 5]
    w = torch.zeros(G, N)
    for g, n in enumerate(n_valid):
        w[g, :n] = 1.0
    X = torch.arange(G * N, dtype=torch.float32).reshape(G, N, 1).expand(G, N, D).contiguous()
    y = torch.zeros(G, N, dtype=torch.int64)
    gen = torch.Generator().manual_seed(0)
    seen = [set() for _ in range(G)]
    for _ in range(200):
        xb, _, wb, keeps = T.draw_batch(X, y, w, CFG, gen)
        assert bool((wb == 1).all())
        for g in range(G):
            seen[g].update(int(v) - g * N for v in xb[g, :, 0])
        assert [k.shape for k in keeps] == [(G, CFG.batch_size, h) for h in HIDDEN]
    assert [sorted(s) for s in seen] == [list(range(n)) for n in n_valid]
    kept = torch.cat([k.flatten() for k in keeps]).float().mean()
    assert abs(float(kept) - (1 - CFG.dropout)) < 0.1


def _separable(seed, n=150):
    rng = np.random.RandomState(seed)
    y = np.arange(n) % C
    centers = rng.randn(C, D) * 3.0
    return (centers[y] + rng.randn(n, D)).astype(np.float32), y.astype(np.int32)


def test_cv_and_fit_reach_95_percent_in_both_packages():
    from stutter_tpu_torch.train.splits import stratified_kfold

    X, y = _separable(7)
    folds = stratified_kfold(y, 5, 42)
    cfg = T.MLPTrainConfig(hidden=HIDDEN, n_classes=C, epochs=100, batch_size=32, n_seeds=2)
    jcfg = JT.MLPTrainConfig(hidden=HIDDEN, n_classes=C, epochs=100, batch_size=32, n_seeds=2)
    pred, proba = T.cross_validate_mlp(X, y, folds, cfg, device="cpu")
    jpred, _ = JT.cross_validate_mlp(X, y, folds, jcfg)
    assert proba.shape == (len(y), C)
    np.testing.assert_allclose(proba.sum(-1), 1.0, atol=1e-5)
    assert (pred == y).mean() >= 0.95 and (jpred == y).mean() >= 0.95

    Xt, yt = _separable(7, 60)  # the same centres, new rows
    model = T.fit_mlp(X, y, cfg, device="cpu")
    assert model.n_seeds == 2 and [tuple(w.shape) for w in model.weights] == [
        (2, D, 16), (2, 16, 8), (2, 8, C)]
    with torch.no_grad():
        acc = (model(torch.from_numpy(Xt)).argmax(-1).numpy() == yt).mean()
    jacc = (JT.fit_mlp(X, y, jcfg).predict(Xt) == yt).mean()
    assert acc >= 0.95 and jacc >= 0.95


def _fitted_pair(X, y, cfg):
    """The port's fitted model and the JAX package's FittedMLP on its weights."""
    model = T.fit_mlp(X, y, cfg, device="cpu")
    params = {k: jnp.asarray(v) for k, v in model.to_jax_params().items()}
    jcfg = JT.MLPTrainConfig(hidden=cfg.hidden, n_classes=cfg.n_classes, n_seeds=cfg.n_seeds)
    return model, JT.FittedMLP(params=params, n_seeds=cfg.n_seeds, cfg=jcfg)


def test_permutation_importance_equals_jax_on_the_same_weights():
    from stutter_tpu.importance import permutation_importance_tpu as jimp
    from stutter_tpu_torch.importance import permutation_importance_tpu

    rng = np.random.RandomState(8)
    X = rng.randn(60, D).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 3] + 0.3 * rng.randn(60)) > 0).astype(np.int32)
    cfg = T.MLPTrainConfig(hidden=HIDDEN, n_classes=2, epochs=10, batch_size=16, n_seeds=2)
    model, fitted = _fitted_pair(X, y, cfg)
    mean, std = permutation_importance_tpu(model, X, y, n_repeats=4, seed=3, eval_batch=7)
    jmean, jstd = jimp(fitted, X, y, n_repeats=4, seed=3, eval_batch=7)
    assert mean.shape == std.shape == (D,)
    assert np.abs(mean - jmean).max() <= 1 / len(y) + 1e-9
    assert np.abs(std - jstd).max() <= 1 / len(y) + 1e-9


def test_permutation_importance_finds_the_signal_feature():
    """The label depends on feature 2 only: it has the largest mean drop,
    and the model is accurate (>= 0.8, a margin below the JAX test's
    flaky > 0.9)."""
    from stutter_tpu_torch.importance import permutation_importance_tpu

    rng = np.random.RandomState(9)
    X = rng.randn(120, D).astype(np.float32)
    y = (X[:, 2] > 0).astype(np.int32)
    cfg = T.MLPTrainConfig(hidden=HIDDEN, n_classes=2, epochs=100, batch_size=32, n_seeds=2)
    model = T.fit_mlp(X, y, cfg, device="cpu")
    with torch.no_grad():
        acc = (model(torch.from_numpy(X)).argmax(-1).numpy() == y).mean()
    mean, _ = permutation_importance_tpu(model, X, y, n_repeats=5)
    assert acc >= 0.8
    assert int(mean.argmax()) == 2 and mean[2] > 0.2


def test_saved_model_loads_into_the_jax_package(tmp_path):
    """persist.save_mlp of a trained SeedMLP -> stutter_tpu.persist.load_mlp:
    its predict_proba equals the port's within 1e-5."""
    from stutter_tpu import persist as jpersist
    from stutter_tpu_torch import persist

    X, y = _separable(10, 60)
    cfg = T.MLPTrainConfig(hidden=HIDDEN, n_classes=C, epochs=5, batch_size=16, n_seeds=3)
    model = T.fit_mlp(X, y, cfg, device="cpu")
    persist.save_mlp(tmp_path / "model_mlp_tpu", model)
    theirs = jpersist.load_mlp(tmp_path / "model_mlp_tpu")
    assert theirs.n_seeds == 3 and theirs.cfg.hidden == HIDDEN and theirs.cfg.n_classes == C
    with torch.no_grad():
        ours = model(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(theirs.predict_proba(X), ours, rtol=0, atol=1e-5)
    back = persist.load_mlp(tmp_path / "model_mlp_tpu", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.weights, model.weights))
