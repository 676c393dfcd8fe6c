"""Training of the feature-vector MLP (counterpart of
stutter_tpu/train/trainer.py).

The whole (folds x seeds) grid -- 5 x 8 = 40 MLPs for engine B's CV --
trains as one set of stacked parameters, [G, d_in, d_out] per layer: a step
is one batched product per layer forward and backward (`apply_mlp_grid`)
and one Adam update over all G.  The G losses are summed, never averaged:
each entry's gradient is then its own loss's, as in the JAX package's vmap,
and the weight decay added to it keeps its weight.

The port holds optax's parts, not its random bits:
  * `optax.chain(add_decayed_weights(wd), adam(schedule))` adds L2 to the
    gradient before Adam: `torch.optim.Adam(weight_decay=wd)`, not AdamW,
    with both libraries' default betas and eps;
  * `cosine_decay_schedule(lr, total_steps, alpha=0.01)` is read at the
    step count before the update (step 0 runs at the full rate) and floors
    at 1 % of it; `learning_rate` sets each step's rate from that formula;
  * the loss is softmax cross-entropy against (1-a)*onehot + a/C targets,
    sum(l*w) / max(sum w, 1);
  * batches are drawn with replacement, weighted by the sample mask, so a
    padded fold row (w = 0) is never drawn; steps = epochs *
    max(1, n_train // batch) with the padded row count;
  * grid entry (fold k, seed s) starts from init_mlp(cfg.seed + s) in every
    fold, drawn on the host from np.random.RandomState, so every device
    starts from the same weights; batches and dropout masks come from one
    torch.Generator on the device, with no host sync per step;
  * over a mesh of devices the grid's entries split into contiguous slices,
    one GridTrainer each, while the draws stay whole on the first device
    (`train_mlp_grid`): a mesh changes where an entry trains, not what.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.models.mlp import SeedMLP, apply_mlp_grid, init_mlp
from stutter_tpu_torch.parallel.mesh import grid_shards, resolve_mesh

LR_FLOOR = 0.01  # cosine_decay_schedule's alpha


@dataclasses.dataclass(frozen=True)
class MLPTrainConfig:
    hidden: tuple = (256, 128, 64)
    n_classes: int = 3
    epochs: int = 200
    batch_size: int = 128
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    dropout: float = 0.2
    label_smoothing: float = 0.05
    seed: int = 42
    n_seeds: int = 8


def total_steps(cfg: MLPTrainConfig, n_train: int) -> int:
    return cfg.epochs * max(1, n_train // cfg.batch_size)


def learning_rate(step: int, n_steps: int, cfg: MLPTrainConfig) -> float:
    """optax.cosine_decay_schedule(cfg.learning_rate, n_steps, alpha=0.01)
    at `step`."""
    cosine = 0.5 * (1.0 + math.cos(math.pi * min(step, n_steps) / n_steps))
    return cfg.learning_rate * ((1.0 - LR_FLOOR) * cosine + LR_FLOOR)


def grid_losses(weights, biases, x, y, w, keeps, cfg: MLPTrainConfig) -> torch.Tensor:
    """x [G, B, D], y [G, B] int, w [G, B], keeps (or None) -> [G]: each
    entry's label-smoothed cross-entropy, sum(l*w) / max(sum w, 1)."""
    logits = apply_mlp_grid(weights, biases, x, keeps, cfg.dropout)
    n_cls = logits.shape[-1]
    targets = (torch.nn.functional.one_hot(y.long(), n_cls).to(logits.dtype)
               * (1.0 - cfg.label_smoothing) + cfg.label_smoothing / n_cls)
    losses = -(targets * torch.log_softmax(logits, dim=-1)).sum(-1)
    return (losses * w).sum(-1) / torch.clamp_min(w.sum(-1), 1.0)


def init_grid(seeds, in_dim: int, cfg: MLPTrainConfig,
              device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    """Stacked init_mlp(seed) weights, one grid entry per seed, on `device`."""
    dev = resolve_device(device)
    by_seed = {s: init_mlp(s, in_dim, cfg.hidden, cfg.n_classes) for s in set(map(int, seeds))}
    inits = [by_seed[int(s)] for s in seeds]
    return {k: torch.as_tensor(np.stack([p[k] for p in inits]), device=dev) for k in inits[0]}


class GridTrainer:
    """G stacked MLPs, one Adam over all of them and the cosine schedule.
    `step` takes a drawn batch (`draw_batch`) or one fed by the caller."""

    def __init__(self, params: dict[str, torch.Tensor], cfg: MLPTrainConfig, n_steps: int):
        n = len(params) // 2
        self.weights = [params[f"w{i}"].detach().clone().requires_grad_(True) for i in range(n)]
        self.biases = [params[f"b{i}"].detach().clone().requires_grad_(True) for i in range(n)]
        self.cfg, self.n_steps, self.steps_done = cfg, n_steps, 0
        self.opt = torch.optim.Adam(self.weights + self.biases, lr=cfg.learning_rate,
                                    weight_decay=cfg.weight_decay)

    def step(self, x, y, w, keeps) -> None:
        """One update from a batch x [G, B, D], y [G, B], w [G, B] and the
        hidden layers' keep-masks [G, B, h] (None without dropout)."""
        for group in self.opt.param_groups:
            group["lr"] = learning_rate(self.steps_done, self.n_steps, self.cfg)
        self.opt.zero_grad(set_to_none=True)
        grid_losses(self.weights, self.biases, x, y, w, keeps, self.cfg).sum().backward()
        self.opt.step()
        self.steps_done += 1

    def params(self) -> dict[str, torch.Tensor]:
        out = {}
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            out[f"w{i}"], out[f"b{i}"] = w.detach(), b.detach()
        return out


def draw_rows(w, cfg: MLPTrainConfig, gen: torch.Generator):
    """A step's draws for the grid from `gen` on w's device: rows idx [G, B]
    of each entry's sample mask w [G, N], with replacement and probability
    w / sum w, then the hidden layers' dropout keep-masks [G, B, h] (None
    without dropout)."""
    G = w.shape[0]
    idx = torch.multinomial(w, cfg.batch_size, replacement=True, generator=gen)
    keeps = None
    if cfg.dropout > 0.0:
        keeps = [torch.rand(G, cfg.batch_size, h, generator=gen, device=w.device)
                 < 1.0 - cfg.dropout for h in cfg.hidden]
    return idx, keeps


def gather_rows(X, y, w, idx):
    """Each entry's drawn rows idx [G, B] of X [G, N, D], y [G, N], w [G, N]."""
    rows = torch.arange(X.shape[0], device=X.device)[:, None]
    return X[rows, idx], y[rows, idx], w[rows, idx]


def draw_batch(X, y, w, cfg: MLPTrainConfig, gen: torch.Generator):
    """A batch per grid entry from X [G, N, D], y [G, N], w [G, N], drawn
    with replacement with probability w / sum w, and the dropout keep-masks,
    both from `gen` on the data's device -> the arguments of
    GridTrainer.step."""
    idx, keeps = draw_rows(w, cfg, gen)
    return (*gather_rows(X, y, w, idx), keeps)


def train_mlp_grid(X, y, w, seeds, cfg: MLPTrainConfig, n_train: int, *,
                   device: torch.device | str = "cuda", mesh=None) -> dict[str, torch.Tensor]:
    """Train G independent MLPs together on X [G, N, D], y [G, N], the
    sample mask w [G, N] (0 for padding) and seeds [G] -> stacked params
    {w{i}: [G, d_in, d_out], b{i}: [G, d_out]} on the mesh's first device.

    The mesh (parallel.mesh.resolve_mesh of `mesh` and `device`) splits the
    grid into contiguous slices (grid_shards), each trained by its own
    GridTrainer on its device, the devices stepped in turn.  Every step's
    rows and dropout masks are drawn for the whole grid on the first device
    from one generator and each device is sent its slice, so the draws, and
    the result, do not depend on the mesh."""
    shards = grid_shards(len(seeds), resolve_mesh(mesh, device))
    dev0 = shards[0][0]
    seeds = np.asarray(list(seeds))
    w0 = torch.as_tensor(w, dtype=torch.float32, device=dev0)
    n_steps = total_steps(cfg, n_train)
    parts = []
    for dev, s in shards:
        data = (torch.as_tensor(X[s], dtype=torch.float32, device=dev),
                torch.as_tensor(y[s], dtype=torch.int64, device=dev), w0[s].to(dev))
        parts.append((dev, s, data,
                      GridTrainer(init_grid(seeds[s], X.shape[-1], cfg, dev), cfg, n_steps)))
    gen = torch.Generator(device=dev0)
    gen.manual_seed(cfg.seed)
    for _ in range(n_steps):
        idx, keeps = draw_rows(w0, cfg, gen)
        for dev, s, data, trainer in parts:
            trainer.step(*gather_rows(*data, idx[s].to(dev)),
                         None if keeps is None else [k[s].to(dev) for k in keeps])
    params = [trainer.params() for *_, trainer in parts]
    return {k: torch.cat([p[k].to(dev0) for p in params]) for k in params[0]}


@torch.no_grad()
def predict_proba_grid(params: dict[str, torch.Tensor], X: torch.Tensor) -> torch.Tensor:
    """Stacked params [G, ...] and X [G, M, D] -> [G, M, C] probabilities."""
    n = len(params) // 2
    logits = apply_mlp_grid([params[f"w{i}"] for i in range(n)],
                            [params[f"b{i}"] for i in range(n)], X)
    return torch.softmax(logits, dim=-1)


def fit_mlp(X: np.ndarray, y: np.ndarray, cfg: MLPTrainConfig = MLPTrainConfig(), *,
            device: torch.device | str = "cuda", mesh=None) -> SeedMLP:
    """Train one seed-ensembled MLP (cfg.n_seeds members) on all of (X, y),
    its seeds over the mesh (train_mlp_grid) -> the SeedMLP that
    persist.save_mlp writes and Predictor serves, on the mesh's first
    device."""
    mesh = resolve_mesh(mesh, device)
    dev = mesh[0]
    G = cfg.n_seeds
    N, D = X.shape
    Xg = torch.as_tensor(np.asarray(X, np.float32), device=dev).expand(G, N, D)
    yg = torch.as_tensor(np.asarray(y, np.int64), device=dev).expand(G, N)
    wg = torch.ones(G, N, device=dev)
    params = train_mlp_grid(Xg, yg, wg, range(cfg.seed, cfg.seed + G), cfg, n_train=N,
                            mesh=mesh)
    n = len(params) // 2
    return SeedMLP([params[f"w{i}"] for i in range(n)], [params[f"b{i}"] for i in range(n)])


def cross_validate_mlp(
    X: np.ndarray,
    y: np.ndarray,
    folds: list[tuple[np.ndarray, np.ndarray]],
    cfg: MLPTrainConfig = MLPTrainConfig(),
    *,
    device: torch.device | str = "cuda",
    mesh=None,
) -> tuple[np.ndarray, np.ndarray]:
    """K-fold CV with all folds x seeds trained as one grid, split over the
    mesh (train_mlp_grid; every visible GPU for an unindexed `cuda`).

    folds: list of (train_idx, test_idx).  Returns (y_pred, y_proba) aligned
    with X's row order (each row predicted by the fold that held it out, the
    soft vote of its cfg.n_seeds members)."""
    mesh = resolve_mesh(mesh, device)
    dev = mesh[0]
    K = len(folds)
    G = K * cfg.n_seeds
    N, D = X.shape
    n_tr_max = max(len(tr) for tr, _ in folds)

    Xg = np.zeros((G, n_tr_max, D), np.float32)
    yg = np.zeros((G, n_tr_max), np.int64)
    wg = np.zeros((G, n_tr_max), np.float32)
    seeds = np.zeros(G, np.int64)
    for k, (tr, _) in enumerate(folds):
        for s in range(cfg.n_seeds):
            g = k * cfg.n_seeds + s
            Xg[g, : len(tr)] = X[tr]
            yg[g, : len(tr)] = y[tr]
            wg[g, : len(tr)] = 1.0
            seeds[g] = cfg.seed + s
    params = train_mlp_grid(Xg, yg, wg, seeds, cfg, n_train=n_tr_max, mesh=mesh)

    # every grid entry on the full X, then each fold's test rows
    Xfull = torch.as_tensor(np.asarray(X, np.float32), device=dev).expand(G, N, D)
    probs = predict_proba_grid(params, Xfull).cpu().numpy()  # [G, N, C]
    probs = probs.reshape(K, cfg.n_seeds, N, -1).mean(axis=1)  # seed soft vote

    y_proba = np.zeros((N, probs.shape[-1]), np.float32)
    for k, (_, te) in enumerate(folds):
        y_proba[te] = probs[k][te]
    return y_proba.argmax(axis=-1), y_proba
