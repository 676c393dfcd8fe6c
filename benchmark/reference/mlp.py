"""The MLP cross-validation grid's first steps, in plain PyTorch: a frozen
copy of the port's training step (train/trainer.py: the grid's layout,
init_mlp's He weights, draw_rows, grid_losses, torch's Adam with L2
weight decay, the cosine schedule), cut loose from the port.

`Grid` lays the folds out as cross_validate_mlp does (G = folds x seeds
entries, each its fold's training rows, zero-padded, with a 0/1 mask);
`first_steps` trains it k steps in the dtype asked for and returns what
the check compares: each step's losses, the first gradient as Adam gets
it (the weight decay added) and each leaf's parameters after k steps.
The draws (rows and dropout masks) are made here again, from a generator
seeded as the port seeds its own, on the same device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

LR_FLOOR = 0.01  # the cosine schedule's alpha
BETAS, EPS = (0.9, 0.999), 1e-8  # torch.optim.Adam's defaults


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    hidden: tuple
    n_classes: int
    epochs: int
    batch_size: int
    learning_rate: float
    weight_decay: float
    dropout: float
    label_smoothing: float
    n_seeds: int
    seed: int


def init_mlp(seed: int, in_dim: int, hidden, n_classes: int) -> list[np.ndarray]:
    """He weights randn(d_in, d_out) * sqrt(2 / d_in) and zero biases, layer
    by layer from np.random.RandomState(seed): [w0, b0, w1, b1, ...]."""
    rng = np.random.RandomState(seed)
    dims = [in_dim, *hidden, n_classes]
    out = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        out.append((rng.randn(d_in, d_out) * np.sqrt(2.0 / d_in)).astype(np.float32))
        out.append(np.zeros(d_out, np.float32))
    return out


def learning_rate(step: int, n_steps: int, cfg: MLPConfig) -> float:
    cosine = 0.5 * (1.0 + math.cos(math.pi * min(step, n_steps) / n_steps))
    return cfg.learning_rate * ((1.0 - LR_FLOOR) * cosine + LR_FLOOR)


class Grid:
    """The CV grid of features X [N, D], labels y [N] and folds: entry
    g = fold * n_seeds + s trains on its fold's rows from seed cfg.seed + s."""

    def __init__(self, X: np.ndarray, y: np.ndarray, folds, cfg: MLPConfig):
        G = len(folds) * cfg.n_seeds
        n_max = max(len(tr) for tr, _ in folds)
        self.X = np.zeros((G, n_max, X.shape[1]), np.float32)
        self.y = np.zeros((G, n_max), np.int64)
        self.w = np.zeros((G, n_max), np.float32)
        self.seeds = np.zeros(G, np.int64)
        for k, (tr, _) in enumerate(folds):
            for s in range(cfg.n_seeds):
                g = k * cfg.n_seeds + s
                self.X[g, : len(tr)], self.y[g, : len(tr)] = X[tr], y[tr]
                self.w[g, : len(tr)] = 1.0
                self.seeds[g] = cfg.seed + s
        self.n_steps = cfg.epochs * max(1, n_max // cfg.batch_size)
        self.cfg = cfg

    def params(self, device, dtype) -> list[torch.Tensor]:
        inits = [init_mlp(int(s), self.X.shape[-1], self.cfg.hidden, self.cfg.n_classes)
                 for s in self.seeds]
        return [torch.as_tensor(np.stack([p[i] for p in inits]), device=device, dtype=dtype)
                for i in range(len(inits[0]))]


def forward(params: list, x: torch.Tensor, keeps, dropout: float) -> torch.Tensor:
    h = x
    last = len(params) // 2 - 1
    for i in range(last + 1):
        h = torch.baddbmm(params[2 * i + 1].unsqueeze(1), h, params[2 * i])
        if i < last:
            h = torch.relu(h)
            if keeps is not None:
                h = torch.where(keeps[i], h / (1.0 - dropout), 0.0)
    return h


def losses(params: list, x, y, w, keeps, cfg: MLPConfig) -> torch.Tensor:
    """[G]: each entry's label-smoothed cross-entropy, sum(l w) / max(sum w, 1)."""
    logits = forward(params, x, keeps, cfg.dropout)
    n_cls = logits.shape[-1]
    t = (torch.nn.functional.one_hot(y, n_cls).to(logits.dtype) * (1.0 - cfg.label_smoothing)
         + cfg.label_smoothing / n_cls)
    per_row = -(t * torch.log_softmax(logits, dim=-1)).sum(-1)
    return (per_row * w).sum(-1) / torch.clamp_min(w.sum(-1), 1.0)


def first_steps(grid: Grid, k: int, device, dtype, rows_used: int | None = None) -> dict:
    """k steps of the grid in `dtype` -> {"losses": [k, G], "grad": the
    first step's gradient with weight decay per leaf, "params0" and
    "params": each leaf before the first and after the k-th step}, all
    float64 on the host.  `rows_used` (a planted fault only) takes the
    loss over the first rows of each drawn batch and leaves out the rest."""
    cfg = grid.cfg
    params = [p.requires_grad_(True) for p in grid.params(device, dtype)]
    p0 = [p.detach().double().cpu().clone() for p in params]
    X = torch.as_tensor(grid.X, device=device, dtype=dtype)
    y = torch.as_tensor(grid.y, device=device)
    w_f32 = torch.as_tensor(grid.w, device=device)  # the draws' weights, as the port's
    w = w_f32.to(dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    rows = torch.arange(X.shape[0], device=device)[:, None]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    out_losses, grad = [], None
    for t in range(1, k + 1):
        idx = torch.multinomial(w_f32, cfg.batch_size, replacement=True, generator=gen)
        keeps = None
        if cfg.dropout > 0.0:
            keeps = [torch.rand(X.shape[0], cfg.batch_size, h, generator=gen, device=device)
                     < 1.0 - cfg.dropout for h in cfg.hidden]
        if rows_used is not None:
            idx = idx[:, :rows_used]
            keeps = None if keeps is None else [m[:, :rows_used] for m in keeps]
        per = losses(params, X[rows, idx], y[rows, idx], w[rows, idx], keeps, cfg)
        out_losses.append(per.detach().double().cpu().clone())
        gs = torch.autograd.grad(per.sum(), params)
        lr = learning_rate(t - 1, grid.n_steps, cfg)
        with torch.no_grad():
            gs = [g + cfg.weight_decay * p for g, p in zip(gs, params)]
            if t == 1:
                grad = [g.double().cpu().clone() for g in gs]
            for p, g, mi, vi in zip(params, gs, m, v):
                mi.mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                vi.mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                denom = (vi.sqrt() / math.sqrt(1.0 - BETAS[1] ** t)).add_(EPS)
                p.addcdiv_(mi, denom, value=-lr / (1.0 - BETAS[0] ** t))
    return {"losses": torch.stack(out_losses), "grad": grad, "params0": p0,
            "params": [p.detach().double().cpu().clone() for p in params]}
