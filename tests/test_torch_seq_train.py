"""The port's sequence-head trainer (stutter_tpu_torch.train.seq_trainer)
against the JAX package's on the CPU, at small widths (CNN channels (4, 8),
CNN-BiLSTM conv 8 / LSTM 8, transformer d_model 16 with one block; D = 12,
T = 24, batch 8).

The two packages draw from different generators, so the tests hold the
parts and the outcome: the loss and fed optimizer steps (the same rows,
SpecAugment spans -- read from the JAX key as _spec_augment draws them --
mixup's lam and permutation, on the JAX package's initial weights) against
optax's chain; the host sampler; a grid entry against the same entry
trained alone; checkpoint resume; and accuracy on separable data, with
hard and with swapped soft targets, in both packages.  Every test seeds
its own numpy generator."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stutter_tpu.train import seq_trainer as J
from stutter_tpu.train.seq_pipeline import ARCHS as JARCHS
from stutter_tpu_torch.train import seq_trainer as S
from stutter_tpu_torch.train.seq_pipeline import ARCHS

torch.set_num_threads(2)

D, T, B, C = 12, 24, 8, 3
KW = {"cnn": {"n_mels": D, "channels": (4, 8), "n_classes": C},
      "cnn_bilstm": {"in_dim": D, "conv_channels": (8,), "lstm_dim": 8, "n_classes": C},
      "transformer": {"n_mels": D, "d_model": 16, "n_blocks": 1, "d_ff": 16, "n_classes": C}}
CASES = {"plain": {}, "mixup": {"mixup_alpha": 0.4}, "balanced": {"class_balanced": True},
         "specaugment": {"time_masks": 2, "time_width": 5, "freq_masks": 1, "freq_width": 4},
         "y_soft": {}}


def _jax_params(arch, seed):
    """The JAX package's initial weights, biases and gains perturbed."""
    p = JARCHS[arch]["init_fn"](jax.random.PRNGKey(seed), **KW[arch])
    rng = np.random.RandomState(seed + 100)
    return {k: (np.asarray(v) + 0.05 * rng.randn(*np.shape(v))).astype(np.float32)
            for k, v in p.items()}


def _data(seed, n=40):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, T, D).astype(np.float32) * 2 + 1
    nv = rng.randint(3, T + 1, n)
    X *= (np.arange(T)[None] < nv[:, None])[..., None]
    y = np.arange(n) % C
    return X, nv, y, rng.randn(D).astype(np.float32), (0.5 + rng.rand(D)).astype(np.float32)


def _jax_spans(key, nvb, cfg):
    """The spans _spec_augment draws from `key` (its splits, in its order)."""
    out = {"t_start": [], "t_width": [], "f_start": [], "f_width": []}
    rng = key
    for _ in range(cfg.time_masks):
        rng, r1, r2 = jax.random.split(rng, 3)
        w = jax.random.randint(r1, (B, 1), 0, cfg.time_width + 1)
        start = (jax.random.uniform(r2, (B, 1)) * jnp.maximum(jnp.asarray(nvb)[:, None] - w, 1))
        out["t_width"].append(np.asarray(w[:, 0]))
        out["t_start"].append(np.asarray(start.astype(jnp.int32)[:, 0]))
    for _ in range(cfg.freq_masks):
        rng, r1, r2 = jax.random.split(rng, 3)
        out["f_width"].append(np.asarray(jax.random.randint(r1, (B, 1), 0, cfg.freq_width + 1))[:, 0])
        out["f_start"].append(np.asarray(jax.random.randint(
            r2, (B, 1), 0, max(D - cfg.freq_width, 1)))[:, 0])
    return {k: np.stack(v, -1) for k, v in out.items() if v}


def _feeds(case, seed, n_steps, X, nv, y):
    """(cfg, JAX cfg, the entry's draws, the JAX SpecAugment keys, y_soft)."""
    cfg = S.SeqTrainConfig(batch_size=B, learning_rate=3e-3, **CASES[case])
    jcfg = J.SeqTrainConfig(batch_size=B, learning_rate=3e-3, **CASES[case])
    w = S.balanced_row_weights(y, C) if cfg.class_balanced else np.ones(len(y))
    draws = S.draw_steps(seed, w, nv, n_steps, cfg, D)
    keys = [jax.random.PRNGKey(1000 + t) for t in range(n_steps)]
    if cfg.time_masks:
        spans = [_jax_spans(k, nv[draws["idx"][t]], cfg) for t, k in enumerate(keys)]
        draws.update({k: np.stack([s[k] for s in spans]) for k in spans[0]})
    y_soft = None
    if case == "y_soft":
        y_soft = np.random.RandomState(seed).dirichlet(np.ones(C), len(y)).astype(np.float32)
    return cfg, jcfg, draws, keys, y_soft


def _jax_batch(X, nv, rows_t, mean, std, draws, t, cfg, key):
    """The JAX grid step's batch (stutter_tpu/train/seq_trainer.py:322-348)
    from fed draws."""
    idx = draws["idx"][t]
    nvb = jnp.asarray(nv[idx])
    mb = jnp.arange(T)[None, :] < nvb[:, None]
    xb = (jnp.asarray(X[idx]) - mean) / std * mb[:, :, None]
    targets = jnp.asarray(rows_t[idx])
    if cfg.time_masks or cfg.freq_masks:
        xb = J._spec_augment(key, xb, nvb, cfg)
    if cfg.mixup_alpha > 0.0:
        lam, perm = jnp.asarray(draws["lam"][t]), draws["perm"][t]
        xb = lam[:, None, None] * xb + (1.0 - lam)[:, None, None] * xb[perm]
        mb = mb | (jnp.arange(T)[None, :] < nvb[perm][:, None])
        targets = lam[:, None] * targets + (1.0 - lam)[:, None] * targets[perm]
    return xb, mb, targets


_GRADS = {}


def _jax_value_and_grad(arch):
    if arch not in _GRADS:
        apply_fn = JARCHS[arch]["apply_fn"]

        def loss_fn(params, xb, mb, targets):
            return jnp.mean(optax.softmax_cross_entropy(apply_fn(params, xb, mb), targets))

        _GRADS[arch] = jax.jit(jax.value_and_grad(loss_fn))
    return _GRADS[arch]


def _jax_rows(y, jcfg, y_soft):
    if y_soft is not None:
        return y_soft
    return np.asarray(optax.smooth_labels(jax.nn.one_hot(y, C), jcfg.label_smoothing))


def _port(arch, params, X, nv, y, mean, std, draws, cfg, n_total, y_soft):
    grid = S.SeqGrid(ARCHS[arch]["module"], [params], "cpu")
    trainer = S.SeqGridTrainer(grid, cfg, n_total)
    steps = S.GridSteps(X, nv, S.row_targets(y, C, cfg, y_soft), mean[None], std[None], [draws],
                        [7], cfg, "cpu")
    return grid, trainer, steps


@pytest.mark.parametrize("arch", list(KW))
def test_loss_equals_the_jax_loss_on_the_same_weights_batch_and_masks(arch):
    """Two entries, their batches mixed up and masked: each entry's loss
    equals apply_* + optax.softmax_cross_entropy + smooth_labels within 1e-6."""
    X, nv, y, mean, std = _data(1)
    cfg = S.SeqTrainConfig(batch_size=B, mixup_alpha=0.3, time_masks=1, time_width=4)
    params = [_jax_params(arch, s) for s in (3, 4)]
    draws = [S.draw_steps(s, np.ones(len(y)), nv, 1, cfg, D) for s in (5, 6)]
    keys = [jax.random.PRNGKey(s) for s in (8, 9)]
    for d, k in zip(draws, keys):
        d.update(_jax_spans(k, nv[d["idx"][0]], cfg))
        d.update({n: v[None] for n, v in d.items() if n.startswith(("t_", "f_"))})
    grid = S.SeqGrid(ARCHS[arch]["module"], params, "cpu")
    steps = S.GridSteps(X, nv, S.row_targets(y, C, cfg), np.stack([mean, mean + 1]),
                        np.stack([std, std * 2]), draws, [5, 6], cfg, "cpu")
    xb, mb, nvh, targets = steps.batch(0)
    with torch.no_grad():
        got = S.seq_losses(grid.logits(xb, mb, nvh), targets).numpy()
    jcfg = J.SeqTrainConfig(batch_size=B, mixup_alpha=0.3, time_masks=1, time_width=4)
    rows = _jax_rows(y, jcfg, None)
    for g in range(2):
        jx = _jax_batch(X, nv, rows, mean + g, std * (1 + g), draws[g], 0, jcfg, keys[g])
        np.testing.assert_array_equal(mb[g].numpy(), np.asarray(jx[1]))
        ref, _ = _jax_value_and_grad(arch)({k: jnp.asarray(v) for k, v in params[g].items()}, *jx)
        assert abs(got[g] - float(ref)) < 1e-6, (arch, g, got[g], float(ref))


def _normwise(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", list(KW))
def test_fed_steps_equal_optax_chain(arch, case):
    """1 and 5 steps with the rows, spans, lam and permutation fed equal
    optax.chain(add_decayed_weights, adam(cosine)) on the JAX package's
    initial weights, per tensor normwise within 1e-4; the losses within
    1e-5."""
    X, nv, y, mean, std = _data(2)
    n_steps, total = 5, 20
    cfg, jcfg, draws, keys, y_soft = _feeds(case, 11, n_steps, X, nv, y)
    params = _jax_params(arch, 21)
    grid, trainer, steps = _port(arch, params, X, nv, y, mean, std, draws, cfg, total, y_soft)

    sched = optax.cosine_decay_schedule(jcfg.learning_rate, total, alpha=0.01)
    opt = optax.chain(optax.add_decayed_weights(jcfg.weight_decay), optax.adam(sched))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    rows = _jax_rows(y, jcfg, y_soft)
    for t in range(n_steps):
        loss = float(trainer.step(*steps.batch(t))[0])
        jloss, grads = _jax_value_and_grad(arch)(
            jp, *_jax_batch(X, nv, rows, mean, std, draws, t, jcfg, keys[t]))
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        assert abs(loss - float(jloss)) < 1e-5 * max(1.0, abs(float(jloss))), (t, loss, jloss)
        if t in (0, n_steps - 1):
            got = grid.params()[0]
            assert sorted(got) == sorted(jp)
            for k, v in jp.items():
                assert _normwise(got[k], v) < 1e-4, (t, k, _normwise(got[k], v))
    moved = [k for k in params if not np.array_equal(got[k], params[k])]
    assert sorted(moved) == sorted(params)


def test_draws_follow_the_weights_the_extent_and_the_recipe():
    """draw_steps: a row of weight 0 is never drawn, rows come in
    proportion to balanced weights, spans lie in [0, width] and start
    within the valid extent, lam >= 0.5, each perm is a permutation, and
    nv after mixup is max(nv, nv[perm]); the same seed draws the same."""
    rng = np.random.RandomState(3)
    n = 60
    y = np.array([0] * 40 + [1] * 15 + [2] * 5)
    nv = rng.randint(2, T + 1, n)
    w = S.balanced_row_weights(y, C)
    w[:4] = 0.0
    cfg = S.SeqTrainConfig(batch_size=32, mixup_alpha=0.2, time_masks=2, time_width=6,
                           freq_masks=1, freq_width=5)
    d = S.draw_steps(9, w, nv, 400, cfg, D)
    assert not np.isin(d["idx"], np.arange(4)).any()
    share = np.bincount(y[d["idx"]].ravel(), minlength=C) / d["idx"].size
    np.testing.assert_allclose(share, 1 / 3, atol=0.02)
    assert (d["t_width"] <= 6).all() and (d["f_width"] <= 5).all() and (d["f_start"] < D - 5).all()
    nvb = nv[d["idx"]][..., None]
    assert (d["t_start"] >= 0).all() and (d["t_start"] < np.maximum(nvb - d["t_width"], 1)).all()
    assert (d["lam"] >= 0.5).all() and (d["lam"] <= 1).all() and d["lam"].dtype == np.float32
    assert (np.sort(d["perm"], axis=1) == np.arange(32)).all()
    np.testing.assert_array_equal(
        d["nv"], np.maximum(nv[d["idx"]], np.take_along_axis(nv[d["idx"]], d["perm"], 1)))
    again = S.draw_steps(9, w, nv, 400, cfg, D)
    assert all(np.array_equal(again[k], v) for k, v in d.items())


@pytest.mark.parametrize("arch", list(KW))
def test_grid_entry_trains_as_it_would_alone(arch):
    """Three entries (own seeds, weights and fold stats) trained as one
    grid equal each trained alone, exactly: the losses are summed, the
    draws are the entry's own, and a stacked head's batched products give
    each member the same result whatever the member count."""
    X, nv, y, _, _ = _data(4, 48)
    rng = np.random.RandomState(5)
    w = (rng.rand(3, len(y)) > 0.3).astype(np.float32)
    mean, std = rng.randn(3, D).astype(np.float32), (1 + rng.rand(3, D)).astype(np.float32)
    cfg = S.SeqTrainConfig(epochs=2, batch_size=B, mixup_alpha=0.2, time_masks=1, time_width=4)
    kw = dict(module=ARCHS[arch]["module"], init_fn=ARCHS[arch]["init_fn"],
              init_items=tuple(KW[arch].items()), n_classes=C, cfg=cfg, n_train=32,
              device="cpu")
    grid = S.train_seq_grid(X, nv, y, w, mean, std, [42, 43, 42], **kw)
    for g in range(3):
        alone = S.train_seq_grid(X, nv, y, w[g:g + 1], mean[g:g + 1], std[g:g + 1],
                                 [[42, 43, 42][g]], **kw)
        for k, v in alone.params()[0].items():
            np.testing.assert_array_equal(grid.params()[g][k], v, err_msg=f"{arch} {g} {k}")
    p = S.predict_seq_grid(grid, X, nv, mean, std, batch=17)
    assert p.shape == (3, len(y), C)
    np.testing.assert_allclose(p.sum(-1), 1.0, atol=1e-5)


def test_checkpointed_interrupted_and_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """train_sequence_model with a checkpoint every 4 of 12 steps, its last
    two checkpoints removed (a run stopped after step 4), resumes from step
    4 and ends equal to a run without checkpoints, exactly; the directory
    keeps the newest 3."""
    from stutter_tpu_torch.utils import checkpoint

    X, nv, y, _, _ = _data(6, 24)
    cfg = S.SeqTrainConfig(epochs=4, batch_size=B, mixup_alpha=0.2, time_masks=1, time_width=3)
    args = (ARCHS["cnn_bilstm"]["module"], ARCHS["cnn_bilstm"]["init_fn"], X, nv, y, C, cfg,
            KW["cnn_bilstm"])
    whole = S.train_sequence_model(*args, device="cpu")
    ck = str(tmp_path / "ck")
    first = S.train_sequence_model(*args, ckpt_dir=ck, ckpt_every=4, device="cpu")
    assert checkpoint.latest_step(ck) == 12
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_12.pt", "step_4.pt", "step_8.pt"]
    for step in (8, 12):
        (tmp_path / "ck" / f"step_{step}.pt").unlink()
    resumed = S.train_sequence_model(*args, ckpt_dir=ck, ckpt_every=4, device="cpu")
    for k, v in whole.items():
        np.testing.assert_array_equal(first[k], v, err_msg=k)
        np.testing.assert_array_equal(resumed[k], v, err_msg=k)
    done = S.train_sequence_model(*args, ckpt_dir=ck, ckpt_every=4, device="cpu")
    assert all(np.array_equal(done[k], v) for k, v in whole.items())  # nothing left to train
    for step in (16, 20):
        checkpoint.save_train_state(ck, step, {"w": torch.zeros(1)}, {})
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_12.pt", "step_16.pt", "step_20.pt"]


def _separable(seed, n=64, n_t=12, d=6):
    rng = np.random.RandomState(seed)
    y = np.arange(n) % 2
    X = (rng.randn(n, n_t, d) * 0.1).astype(np.float32) + y[:, None, None] * 0.8
    return X, np.full(n, n_t, np.int32), y


@pytest.mark.parametrize("soft", [False, True], ids=["labels", "swapped_soft_targets"])
def test_grid_reaches_90_percent_in_both_packages(soft):
    """Each entry of a 2 folds x 2 seeds CNN grid classifies its held-out
    fold of separable data at >= 90 % in both packages; trained on swapped
    soft targets, the grid learns the swapped mapping (>= 90 % against
    1 - y) in both.  160 steps, not the JAX test's 48: there the swapped
    targets' margin is marginal (0.63-1.0 across data seeds), and at 80
    steps a few entries of either package still predict one class."""
    X, nv, y = _separable(7)
    n, n_t, d = X.shape
    half = np.arange(n) // 2 % 2 == 0  # both classes in both halves
    folds = [(np.flatnonzero(half), np.flatnonzero(~half)), (np.flatnonzero(~half), np.flatnonzero(half))]
    G, n_seeds = 4, 2
    w = np.zeros((G, n), np.float32)
    for k, (tr, _) in enumerate(folds):
        w[k * n_seeds : (k + 1) * n_seeds, tr] = 1.0
    seeds = np.array([42, 43, 42, 43], np.int32)
    mean, std = np.zeros((G, d), np.float32), np.ones((G, d), np.float32)
    y_soft = np.eye(2, dtype=np.float32)[1 - y] if soft else None
    truth = 1 - y if soft else y
    items = (("channels", (8,)), ("n_classes", 2), ("n_mels", d))
    cfg = S.SeqTrainConfig(epochs=40, batch_size=8)
    grid = S.train_seq_grid(X, nv, y, w, mean, std, seeds, module=ARCHS["cnn"]["module"],
                            init_fn=ARCHS["cnn"]["init_fn"], init_items=items, n_classes=2,
                            cfg=cfg, n_train=n // 2, y_soft=y_soft, device="cpu")
    probs = S.predict_seq_grid(grid, X, nv, mean, std)
    jparams = J.train_seq_grid(
        jnp.asarray(X), jnp.asarray(nv), jnp.asarray(y), jnp.asarray(w), jnp.asarray(mean),
        jnp.asarray(std), jnp.asarray(seeds), init_fn=JARCHS["cnn"]["init_fn"],
        apply_fn=JARCHS["cnn"]["apply_fn"], init_items=items, n_classes=2,
        cfg=J.SeqTrainConfig(epochs=40, batch_size=8), n_train=n // 2,
        y_soft=None if y_soft is None else jnp.asarray(y_soft))
    jprobs = J.predict_seq_grid(JARCHS["cnn"]["apply_fn"], jparams, X, nv, mean, std)
    for k, (_, te) in enumerate(folds):
        for p in (probs, jprobs):
            vote = p[k * n_seeds : (k + 1) * n_seeds, te].mean(0)
            assert (vote.argmax(-1) == truth[te]).mean() >= 0.9, (soft, k)


def test_noise_lies_within_the_mask_and_replays():
    """noise_std: Gaussian noise on the valid frames only, the same for a
    step drawn again (a resumed run), another for another step or seed."""
    X, nv, y, mean, std = _data(8)
    cfg = S.SeqTrainConfig(batch_size=B, noise_std=0.5)
    draws = [S.draw_steps(s, np.ones(len(y)), nv, 2, cfg, D) for s in (3, 4)]

    def steps(c):
        return S.GridSteps(X, nv, S.row_targets(y, C, c), np.stack([mean] * 2),
                           np.stack([std] * 2), draws, [3, 4], c, "cpu")

    noisy, plain = steps(cfg), steps(S.SeqTrainConfig(batch_size=B))
    x0, mb, _, _ = noisy.batch(0)
    m = mb.numpy()
    d = (x0 - plain.batch(0)[0]).numpy()
    n0 = noisy._noise(0, x0.shape[1:])
    np.testing.assert_allclose(d, (0.5 * n0 * mb[..., None]).numpy(), rtol=0, atol=1e-6)
    assert not d[~m].any() and d[m].std() > 0.4
    assert torch.equal(n0, noisy._noise(0, x0.shape[1:]))  # replayed
    assert not torch.allclose(n0, noisy._noise(1, x0.shape[1:]))  # another step
    assert not torch.allclose(n0[0], n0[1])  # another seed
