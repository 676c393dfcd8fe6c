"""Sequence featurization, training and inference for the sequence heads
(counterpart of stutter_tpu/train/seq_trainer.py).

Log-mel frames (n_fft 2048, hop 512, 128 Slaney mels, librosa's per-clip
80 dB clamp) for the CNN and the transformers, the 20-MFCC + delta +
delta2 stack for the CNN-BiLSTM.  The power spectrum and the mel come from
the spectromel kernel's mel-output mode (`ops.frontend.spect_mel_db`)
without its tuning tail, which nothing here reads; in the JAX package they
are XLA's power_spectrogram and mel_power_to_db, the same function.

Training (`train_sequence_model`, the folds x seeds grid `train_seq_grid`)
holds optax's parts, not its random bits, as train/trainer.py does for the
MLP:
  * chain(add_decayed_weights(wd), adam(cosine_decay_schedule(lr, steps,
    alpha=0.01))) is torch.optim.Adam(weight_decay=wd), the rate set per
    step by `trainer.learning_rate`; steps = epochs * max(1, n_train //
    batch_size);
  * the loss is the batch mean of softmax cross-entropy against
    (1-a)*onehot + a/C, or against the rows of y_soft; the grid's entries'
    losses are summed, so each entry's gradient is its own;
  * each step and entry draws its rows with replacement (p = w / sum w),
    SpecAugment's spans within the valid extent, and mixup's lam ~ Beta(a,
    a), then max(lam, 1 - lam), with one permutation of the batch -- all
    on the host, from one np.random.Generator per grid entry seeded by the
    entry's seed, for every step up front (`draw_steps`), uploaded once per
    grid.  The packed BiLSTM so has its lengths without a copy off the
    device, a resumed run replays the same draws, and an entry's result
    depends neither on the grid's chunking nor on its place in the grid.
    noise_std's Gaussian (off in every published recipe) comes from a
    torch.Generator on the device, seeded by the entry's seed and the step;
  * inputs are standardized with the entry's fold stats and masked, then
    SpecAugment, noise, and last mixup: the inputs and targets mixed, the
    mask mb | mb[perm] (a prefix mask of max(nv, nv[perm]) frames);
  * an entry of seed s starts from the head's numpy init_* drawn from
    np.random.RandomState(s) (cfg.seed + s for seed s of every fold).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.models.layers import StackedParams
from stutter_tpu_torch.ops.delta import sg_deltas
from stutter_tpu_torch.ops.frontend import bucket_groups, host_batches, spect_mel_db
from stutter_tpu_torch.ops.spectral import mfcc_from_db
from stutter_tpu_torch.utils.profiling import span

FEATURE_DIMS = {"logmel": 128, "mfcc_deltas": 60}


@dataclasses.dataclass(frozen=True)
class SeqTrainConfig:
    epochs: int = 60
    batch_size: int = 64
    learning_rate: float = 2e-3
    weight_decay: float = 1e-4
    label_smoothing: float = 0.05
    seed: int = 42
    # --- train-time augmentation (all off by default; reference has none) ---
    noise_std: float = 0.0  # additive N(0, std) on standardized features
    freq_masks: int = 0  # SpecAugment: number of feature-band masks
    freq_width: int = 16  # max width (bins) of each feature-band mask
    time_masks: int = 0  # SpecAugment: number of time masks
    time_width: int = 24  # max width (frames) of each time mask
    mixup_alpha: float = 0.0  # Beta(alpha, alpha) convex mixing of pairs
    # inverse-class-frequency minibatch sampling: each class contributes an
    # equal expected share of every batch; rides the row sampler's weights,
    # so the loss and targets are untouched
    class_balanced: bool = False


def balanced_row_weights(y_rows: np.ndarray, n_classes: int) -> np.ndarray:
    """Inverse-class-frequency sampling weights for one train split: class c's
    rows get n_rows / (n_classes * count_c), so every class contributes an
    equal expected share of each sampled minibatch (sklearn's
    class_weight='balanced' formula, applied to SAMPLING instead of the
    loss).  Mean weight is 1 over the split, matching the unweighted case's
    total mass."""
    counts = np.bincount(y_rows, minlength=n_classes).astype(np.float64)
    counts = np.maximum(counts, 1.0)  # absent classes cannot divide by zero
    return (len(y_rows) / (n_classes * counts[y_rows])).astype(np.float32)


def frames_from_db(db: torch.Tensor, n_valid: torch.Tensor, kinds) -> dict[str, torch.Tensor]:
    """Log-mel [B, T, 128] (n_valid [B] valid frames) -> {kind: [B, T, D]}
    for each of `kinds`: the log-mel itself, or MFCC + delta + delta2."""
    out = {}
    if "logmel" in kinds:
        out["logmel"] = db
    if "mfcc_deltas" in kinds:
        mf = mfcc_from_db(db, 20)
        d1, d2 = sg_deltas(mf, n_valid, orders=(1, 2))
        out["mfcc_deltas"] = torch.cat([mf, d1, d2], dim=-1)
    return out


def seq_frames(audio: torch.Tensor, lengths: torch.Tensor, kinds, sr: int = 16000):
    """[B, N] zero-padded audio, lengths [B] -> ({kind: frames [B, T, D]},
    frame mask [B, T]), every kind from one spectrogram; T = 1 + N // 512."""
    _, mask, db, _ = spect_mel_db(audio, lengths, sr, 2048, 512, 128, with_tuning=False)
    return frames_from_db(db, 1 + torch.div(lengths, 512, rounding_mode="floor"), kinds), mask


def _featurize_seq(audio: torch.Tensor, lengths: torch.Tensor, kind: str, sr: int = 16000):
    """One kind's (frames [B, T, D], frame mask [B, T])."""
    frames, mask = seq_frames(audio, lengths, (kind,), sr)
    return frames[kind], mask


def fit_frames(f: torch.Tensor, t_max: int) -> torch.Tensor:
    """[B, T, D] -> [B, t_max, D]: cut, or zero-padded at the end."""
    T = f.shape[1]
    return f[:, :t_max] if T >= t_max else torch.nn.functional.pad(f, (0, 0, 0, t_max - T))


def prepare_sequence_dataset(
    clips: list[np.ndarray],
    kind: str = "logmel",
    sr: int = 16000,
    t_max: int = 316,
    batch: int = 128,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """clips -> (features [N, t_max, D], n_valid [N]) on the host, padded or
    cut to t_max frames; each bucket of clips featurized in batches on
    `device` (ops.frontend.host_batches; traced, each batch's leaves are
    pad, h2d, launch, d2h and unpad).  kind='logmel': D = 128;
    kind='mfcc_deltas': D = 60."""
    mesh = (resolve_device(device),)
    out = np.zeros((len(clips), t_max, FEATURE_DIMS[kind]), np.float32)
    n_valid = np.zeros(len(clips), np.int32)
    groups = bucket_groups([len(y) for y in clips], batch)
    for chunk, lens, feats in host_batches(
            "prepare_sequence_dataset", clips, groups,
            lambda a, n: _featurize_seq(a, n, kind, sr)[0], mesh, "prepare_sequence_dataset.launch"):
        with span("prepare_sequence_dataset.unpad"):
            for j, i in enumerate(chunk):
                t = min(1 + int(lens[j]) // 512, t_max)
                out[i, :t] = feats[j, :t]
                n_valid[i] = t
    return out, n_valid


def standardize_sequences(X: np.ndarray, n_valid: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-feature standardization over valid frames; returns (Xs, mean, std)."""
    mask = (np.arange(X.shape[1])[None, :] < n_valid[:, None])[..., None]
    cnt = mask.sum()
    mean = (X * mask).sum(axis=(0, 1)) / cnt
    var = (((X - mean) * mask) ** 2).sum(axis=(0, 1)) / cnt
    std = np.sqrt(np.maximum(var, 1e-12))
    return ((X - mean) / std * mask).astype(np.float32), mean, std


def predict_sequence_model(
    model: torch.nn.Module, X: np.ndarray, n_valid: np.ndarray, batch: int = 256,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Standardized [N, T, D] frames + n_valid [N] -> probabilities [N, C],
    in batches on `device` (where `model`'s weights lie)."""
    device = resolve_device(device)
    N, T, _ = X.shape
    outs = []
    with torch.no_grad():
        for s in range(0, N, batch):
            nv = np.asarray(n_valid[s : s + batch])
            mb = torch.arange(T)[None, :] < torch.from_numpy(nv.astype(np.int64))[:, None]
            logits = model(torch.from_numpy(np.ascontiguousarray(X[s : s + batch])).to(device),
                           mb.to(device), nv)
            outs.append(torch.softmax(logits, -1).cpu().numpy())
    return np.concatenate(outs, axis=0)


def draw_steps(seed: int, w: np.ndarray, n_valid: np.ndarray, n_steps: int, cfg: SeqTrainConfig,
               n_feats: int) -> dict[str, np.ndarray]:
    """One grid entry's draws for `n_steps` steps of cfg.batch_size rows,
    from np.random.default_rng(seed): "idx" [S, B] rows (with replacement,
    p = w / sum w); "nv" [S, B] the valid frames of each row after mixup;
    with SpecAugment "t_start" / "t_width" [S, B, time_masks] (the start
    uniform over the row's valid extent less the width) and "f_start" /
    "f_width" [S, B, freq_masks]; with mixup "lam" [S, B] (Beta(a, a), then
    max(lam, 1 - lam)) and "perm" [S, B] (a permutation of the batch)."""
    rng = np.random.default_rng(seed)
    S, B = n_steps, cfg.batch_size
    p = np.asarray(w, np.float64)
    out = {"idx": rng.choice(len(p), (S, B), p=p / p.sum())}
    nv = np.asarray(n_valid, np.int64)[out["idx"]]
    if cfg.time_masks:
        width = rng.integers(0, cfg.time_width + 1, (S, B, cfg.time_masks))
        u = rng.random((S, B, cfg.time_masks))
        out["t_width"] = width
        out["t_start"] = (u * np.maximum(nv[..., None] - width, 1)).astype(np.int64)
    if cfg.freq_masks:
        out["f_width"] = rng.integers(0, cfg.freq_width + 1, (S, B, cfg.freq_masks))
        out["f_start"] = rng.integers(0, max(n_feats - cfg.freq_width, 1), (S, B, cfg.freq_masks))
    if cfg.mixup_alpha > 0.0:
        lam = rng.beta(cfg.mixup_alpha, cfg.mixup_alpha, (S, B))
        out["lam"] = np.maximum(lam, 1.0 - lam).astype(np.float32)
        out["perm"] = np.argsort(rng.random((S, B)), axis=1)
        nv = np.maximum(nv, np.take_along_axis(nv, out["perm"], axis=1))
    out["nv"] = nv
    return out


def row_targets(y: np.ndarray, n_classes: int, cfg: SeqTrainConfig,
                y_soft: np.ndarray | None = None) -> torch.Tensor:
    """Each row's training target [N, C]: its row of y_soft, or its label
    smoothed as optax.smooth_labels does, (1 - a) * onehot + a / C."""
    if y_soft is not None:
        return torch.as_tensor(np.asarray(y_soft, np.float32))
    onehot = torch.nn.functional.one_hot(torch.as_tensor(np.asarray(y, np.int64)), n_classes)
    return onehot.float() * (1.0 - cfg.label_smoothing) + cfg.label_smoothing / n_classes


class SeqGrid:
    """G heads of one architecture, run as the grid trainer and
    predict_seq_grid run them: a stackable head (the CNN, the transformer)
    as one module with a leading member axis, the CNN-BiLSTM -- whose packed
    nn.LSTM takes host lengths and batches over no member axis -- as G
    modules, one after another in one autograd graph."""

    def __init__(self, module: type, params: list[dict], device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        heads = [module.from_jax_params(p, device=self.device) for p in params]
        self.stacked = issubclass(module, StackedParams)
        self.models = torch.nn.ModuleList([module.stack(heads)] if self.stacked else heads)

    def logits(self, x: torch.Tensor, mask: torch.Tensor, n_valid: np.ndarray) -> torch.Tensor:
        """x [G, B, T, D] (each entry's standardized frames), a prefix mask
        [B, T] shared or [G, B, T] per entry, and its valid frames on the
        host ([B] or [G, B]) -> logits [G, B, C]."""
        if self.stacked:
            return self.models[0](x, mask)
        n_valid = np.asarray(n_valid)
        return torch.stack([m(x[g], mask if mask.ndim == 2 else mask[g],
                              n_valid if n_valid.ndim == 1 else n_valid[g])
                            for g, m in enumerate(self.models)])

    def params(self) -> list[dict[str, np.ndarray]]:
        """Each entry's weights in the JAX package's names and layout."""
        if self.stacked:
            return self.models[0].members_jax_params()
        return [m.to_jax_params() for m in self.models]


def seq_losses(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits and targets [G, B, C] -> [G]: each entry's batch mean of
    softmax cross-entropy (optax.softmax_cross_entropy)."""
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(-1).mean(-1)


class SeqGridTrainer:
    """One Adam over every weight of a SeqGrid, the cosine schedule, and a
    step on the summed losses of the grid's entries."""

    def __init__(self, grid: SeqGrid, cfg: SeqTrainConfig, n_steps: int):
        for m in grid.models:
            m.requires_grad_(True)
        self.grid, self.cfg, self.n_steps, self.steps_done = grid, cfg, n_steps, 0
        self.opt = torch.optim.Adam([p for p in grid.models.parameters() if p.requires_grad],
                                    lr=cfg.learning_rate, weight_decay=cfg.weight_decay)

    def step(self, x, mask, n_valid, targets) -> torch.Tensor:
        """One update from a batch (`GridSteps.batch`) -> each entry's loss."""
        from stutter_tpu_torch.train.trainer import learning_rate

        for group in self.opt.param_groups:
            group["lr"] = learning_rate(self.steps_done, self.n_steps, self.cfg)
        self.opt.zero_grad(set_to_none=True)
        losses = seq_losses(self.grid.logits(x, mask, n_valid), targets)
        losses.sum().backward()
        self.opt.step()
        self.steps_done += 1
        return losses.detach()


class GridSteps:
    """What a grid's steps read: the shared dataset and each row's target
    on the device, each entry's standardization stats, and every step's
    draws (uploaded once; the rows' valid frames also kept on the host)."""

    def __init__(self, X: np.ndarray, n_valid: np.ndarray, targets: torch.Tensor,
                 mean_g: np.ndarray, std_g: np.ndarray, draws: list[dict], seeds, cfg,
                 device: torch.device | str = "cuda"):
        dev = self.device = resolve_device(device)
        self.X = torch.as_tensor(np.asarray(X, np.float32), device=dev)
        self.nv = torch.as_tensor(np.asarray(n_valid, np.int64), device=dev)
        self.targets = targets.to(dev)
        self.mean = torch.as_tensor(np.asarray(mean_g, np.float32), device=dev)[:, None, None]
        self.std = torch.as_tensor(np.asarray(std_g, np.float32), device=dev)[:, None, None]
        self.nv_host = np.stack([d["nv"] for d in draws], axis=1)  # [S, G, B]
        self.draws = {k: torch.as_tensor(np.stack([d[k] for d in draws], axis=1), device=dev)
                      for k in draws[0] if k != "nv"}  # [S, G, B, ...]
        self.seeds, self.cfg = [int(s) for s in seeds], cfg
        self.frames = torch.arange(self.X.shape[1], device=dev)
        self.rows = torch.arange(len(draws), device=dev)[:, None]

    def _noise(self, t: int, shape) -> torch.Tensor:
        """Step t's N(0, 1) draws [G, *shape], each entry's from a generator
        seeded by its seed and t (a resumed run draws them again)."""
        noise = []
        for s in self.seeds:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(np.random.SeedSequence([s, t]).generate_state(1)[0]))
            noise.append(torch.randn(shape, generator=gen, device=self.device))
        return torch.stack(noise)

    def batch(self, t: int):
        """Step t's (x [G, B, T, D], mask [G, B, T], valid frames [G, B] on
        the host, targets [G, B, C])."""
        cfg, d = self.cfg, {k: v[t] for k, v in self.draws.items()}
        idx = d["idx"]
        nvb = self.nv[idx]
        mb = self.frames < nvb[..., None]
        xb = (self.X[idx] - self.mean) / self.std * mb[..., None]
        targets = self.targets[idx]
        if cfg.time_masks or cfg.freq_masks:
            keep_t = torch.ones(mb.shape, dtype=xb.dtype, device=xb.device)
            keep_f = torch.ones(xb.shape[:2] + xb.shape[3:], dtype=xb.dtype, device=xb.device)
            for keep, axis, pre in ((keep_t, self.frames, "t"),
                                    (keep_f, torch.arange(xb.shape[3], device=xb.device), "f")):
                if f"{pre}_start" in d:
                    start, width = d[f"{pre}_start"][..., None], d[f"{pre}_width"][..., None]
                    hit = ((axis >= start) & (axis < start + width)).any(-2)
                    keep.mul_(1.0 - hit.to(xb.dtype))
            xb = xb * (keep_t[..., None] * keep_f[..., None, :])
        if cfg.noise_std > 0.0:
            xb = xb + cfg.noise_std * self._noise(t, xb.shape[1:]) * mb[..., None]
        if cfg.mixup_alpha > 0.0:
            lam, perm = d["lam"], d["perm"]
            xb = (lam[..., None, None] * xb
                  + (1.0 - lam)[..., None, None] * xb[self.rows, perm])
            mb = mb | (self.frames < nvb[self.rows, perm][..., None])
            targets = lam[..., None] * targets + (1.0 - lam)[..., None] * targets[self.rows, perm]
        return xb, mb, self.nv_host[t], targets


def _inits(init_fn, seeds, init_kwargs: dict) -> list[dict]:
    return [init_fn(np.random.RandomState(int(s)), **init_kwargs) for s in seeds]


def train_sequence_model(
    module: type,
    init_fn,
    X: np.ndarray,  # [N, T, D] standardized
    n_valid: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    cfg: SeqTrainConfig = SeqTrainConfig(),
    init_kwargs: dict | None = None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 500,
    y_soft: np.ndarray | None = None,
    *,
    device: torch.device | str = "cuda",
) -> dict[str, np.ndarray]:
    """Train one sequence head (`module`, from init_fn's weights at
    cfg.seed) on `device`; returns its weights in the JAX package's names
    and layout.

    With ckpt_dir set, the training state (weights, Adam's state, the step)
    is saved every `ckpt_every` steps (utils/checkpoint.py) and a run
    resumes from the newest checkpoint, replaying the same draws.  y_soft
    [N, C]: soft probability targets replace the smoothed one-hot labels."""
    from stutter_tpu_torch.train.trainer import total_steps
    from stutter_tpu_torch.utils import checkpoint as ckpt

    dev = resolve_device(device)
    N, _, D = X.shape
    n_steps = total_steps(cfg, N)
    grid = SeqGrid(module, _inits(init_fn, [cfg.seed], init_kwargs or {}), dev)
    trainer = SeqGridTrainer(grid, cfg, n_steps)
    step = 0
    if ckpt_dir is not None and (latest := ckpt.latest_step(ckpt_dir)) is not None:
        params, opt_state = ckpt.restore_train_state(ckpt_dir, latest, dev)
        grid.models.load_state_dict(params)
        trainer.opt.load_state_dict(opt_state)
        trainer.steps_done = step = latest
    w = balanced_row_weights(np.asarray(y), n_classes) if cfg.class_balanced else np.ones(N)
    steps = GridSteps(X, n_valid, row_targets(y, n_classes, cfg, y_soft),
                      np.zeros((1, D)), np.ones((1, D)),
                      [draw_steps(cfg.seed, w, n_valid, n_steps, cfg, D)], [cfg.seed], cfg, dev)
    chunk = ckpt_every if ckpt_dir is not None else max(n_steps, 1)
    while step < n_steps:
        stop = min(step + chunk, n_steps)
        for t in range(step, stop):
            trainer.step(*steps.batch(t))
        step = stop
        if ckpt_dir is not None:
            ckpt.save_train_state(ckpt_dir, step, grid.models.state_dict(),
                                  trainer.opt.state_dict())
    return grid.params()[0]


def _grid_parts(X, nv, y, w, mean_g, std_g, seeds, *, module, init_fn, init_items: tuple,
                n_classes: int, cfg: SeqTrainConfig, n_train: int, y_soft=None,
                device: torch.device | str = "cuda"):
    """A grid's heads, their trainer and their steps' inputs on `device`
    (train_seq_grid's arguments) -> (SeqGrid, SeqGridTrainer, GridSteps,
    the step count)."""
    from stutter_tpu_torch.train.trainer import total_steps

    dev = resolve_device(device)
    D = X.shape[2]
    n_steps = total_steps(cfg, n_train)
    grid = SeqGrid(module, _inits(init_fn, seeds, dict(init_items)), dev)
    steps = GridSteps(X, nv, row_targets(y, n_classes, cfg, y_soft), mean_g, std_g,
                      [draw_steps(int(s), w[g], nv, n_steps, cfg, D) for g, s in enumerate(seeds)],
                      seeds, cfg, dev)
    return grid, SeqGridTrainer(grid, cfg, n_steps), steps, n_steps


def train_seq_grid(
    X: np.ndarray,  # [N, T, D] raw (unstandardized) features, SHARED
    nv: np.ndarray,  # [N] valid frame counts, shared
    y: np.ndarray,  # [N] labels, shared
    w: np.ndarray,  # [G, N] per-entry sampling weights (0 = not in this fold's train set)
    mean_g: np.ndarray,  # [G, D] per-entry standardization mean (train rows only)
    std_g: np.ndarray,  # [G, D] per-entry standardization std
    seeds,  # [G] ints
    *,
    module: type,
    init_fn,
    init_items: tuple,  # init_fn's keyword arguments, e.g. (("n_mels", 128), ...)
    n_classes: int,
    cfg: SeqTrainConfig,
    n_train: int,
    y_soft: np.ndarray | None = None,  # [N, C] soft targets (distillation)
    device: torch.device | str = "cuda",
) -> SeqGrid:
    """Train G independent sequence heads together -- a folds x seeds grid
    (its entries' losses summed, one Adam) -- on `device`.

    The dataset is uploaded once and shared by the grid; each entry carries
    only its sampling weights, its fold's standardization stats (each
    sampled batch is standardized on the fly) and its seed.  Per entry, the
    math is train_sequence_model's; its draws come from its own seed and
    weights, so it trains as it would alone.  y_soft: per-row probability
    targets replace the smoothed one-hot labels; `y` then drives nothing in
    the loss."""
    grid, trainer, steps, n_steps = _grid_parts(
        X, nv, y, w, mean_g, std_g, seeds, module=module, init_fn=init_fn,
        init_items=init_items, n_classes=n_classes, cfg=cfg, n_train=n_train, y_soft=y_soft,
        device=device)
    for t in range(n_steps):
        trainer.step(*steps.batch(t))
    return grid


def train_seq_grid_sharded(mesh, X, nv, y, w, mean_g, std_g, seeds,
                           **kw) -> list[tuple[slice, SeqGrid]]:
    """train_seq_grid with the grid's entries split over the mesh into
    contiguous slices (parallel.mesh.grid_shards) -> (slice, its SeqGrid)
    per device.  The devices train in lockstep: step t of every device is
    launched before step t + 1 of any, so they run at once.  An entry's
    draws are its own, so its result does not depend on the mesh; a mesh of
    one is train_seq_grid."""
    from stutter_tpu_torch.parallel.mesh import grid_shards

    shards = grid_shards(len(seeds), mesh)
    if len(shards) == 1:
        dev, s = shards[0]
        return [(s, train_seq_grid(X, nv, y, w, mean_g, std_g, seeds, device=dev, **kw))]
    parts = [_grid_parts(X, nv, y, w[s], mean_g[s], std_g[s], seeds[s], device=dev, **kw)
             for dev, s in shards]
    for t in range(parts[0][3]):
        for _, trainer, steps, _ in parts:
            trainer.step(*steps.batch(t))
    return [(s, grid) for (_, s), (grid, *_) in zip(shards, parts)]


def predict_seq_grid(grid: SeqGrid, X: np.ndarray, n_valid: np.ndarray, mean_g: np.ndarray,
                     std_g: np.ndarray, batch: int = 256) -> np.ndarray:
    """A grid's G heads + raw [N, T, D] -> probabilities [G, N, C]; each
    entry standardizes the shared batch with its own fold stats."""
    dev = grid.device
    N, T, _ = X.shape
    mg = torch.as_tensor(np.asarray(mean_g, np.float32), device=dev)[:, None, None]
    sg = torch.as_tensor(np.asarray(std_g, np.float32), device=dev)[:, None, None]
    outs = []
    with torch.no_grad():
        for s in range(0, N, batch):
            nv = np.asarray(n_valid[s : s + batch])
            mb = (torch.arange(T)[None, :] < torch.from_numpy(nv.astype(np.int64))[:, None]).to(dev)
            xb = torch.from_numpy(np.ascontiguousarray(X[s : s + batch], np.float32)).to(dev)
            xs = (xb[None] - mg) / sg * mb[None, :, :, None]
            outs.append(torch.softmax(grid.logits(xs, mb, nv), -1).cpu().numpy())
    return np.concatenate(outs, axis=1)
