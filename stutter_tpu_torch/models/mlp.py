"""Seed-ensembled MLP classifier head (counterpart of stutter_tpu/models/mlp.py
and the predict side of stutter_tpu/train/trainer.py: predict_proba_grid,
FittedMLP).

The JAX package trains S seeds of one MLP as a stacked pytree (seed axis
first) and predicts with the mean over seeds of the softmax.  `SeedMLP`
holds the same stacked weights, [S, d_in, d_out] and [S, d_out] per layer,
and runs all seeds as one batched product per layer (`apply_mlp_grid`),
which is also the trainer's forward over its [G, ...] grid.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from stutter_tpu_torch.device import resolve_device


def init_mlp(
    seed: int, in_dim: int, hidden: Sequence[int] = (256, 128, 64), n_classes: int = 3
) -> dict[str, np.ndarray]:
    """He-initialized weights in the JAX package's names ({w0, b0, w1, ...}):
    randn(d_in, d_out) * sqrt(2 / d_in), zero biases, drawn layer by layer
    from np.random.RandomState(seed), so every device starts from the same
    weights."""
    rng = np.random.RandomState(seed)
    dims = [in_dim, *hidden, n_classes]
    params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = (rng.randn(d_in, d_out) * np.sqrt(2.0 / d_in)).astype(np.float32)
        params[f"b{i}"] = np.zeros(d_out, np.float32)
    return params


def apply_mlp_grid(
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    x: torch.Tensor,
    keeps: Sequence[torch.Tensor] | None = None,
    dropout: float = 0.0,
) -> torch.Tensor:
    """x [G, M, d_in] through G stacked MLPs (weights [G, d_in, d_out],
    biases [G, d_out]) -> logits [G, M, n_classes].

    `keeps` (training only): one bool keep-mask [G, M, d_out] per hidden
    layer.  As the JAX package's apply_mlp, a kept unit after a hidden ReLU
    is scaled by 1 / (1 - dropout) and a dropped one is 0."""
    h = x
    last = len(weights) - 1
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.baddbmm(b.unsqueeze(1), h, w)
        if i < last:
            h = torch.relu(h)
            if keeps is not None:
                h = torch.where(keeps[i], h / (1.0 - dropout), 0.0)
    return h


def apply_mlp(params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """One MLP in the JAX package's names ({w0: [d_in, d_out], b0: [d_out],
    w1, ...}): x [M, d_in] -> logits [M, n_classes], without dropout."""
    n = len(params) // 2
    return apply_mlp_grid([params[f"w{i}"][None] for i in range(n)],
                          [params[f"b{i}"][None] for i in range(n)], x[None])[0]


class SeedMLP(nn.Module):
    """ReLU MLP with weights stacked over seeds; forward -> seed-mean softmax."""

    def __init__(self, weights: list[torch.Tensor], biases: list[torch.Tensor]):
        super().__init__()
        if len(weights) != len(biases) or not weights:
            raise ValueError("SeedMLP needs one bias per weight and at least one layer")
        self.weights = nn.ParameterList(nn.Parameter(w, requires_grad=False) for w in weights)
        self.biases = nn.ParameterList(nn.Parameter(b, requires_grad=False) for b in biases)

    @classmethod
    def from_jax_params(
        cls, params: dict[str, np.ndarray], device: torch.device | str = "cuda"
    ) -> "SeedMLP":
        """From the JAX pytree {w0, b0, w1, b1, ...}, seed axis first, on
        `device`."""
        device = resolve_device(device)
        n_layers = len(params) // 2
        if sorted(params) != sorted([f"w{i}" for i in range(n_layers)]
                                    + [f"b{i}" for i in range(n_layers)]):
            raise ValueError(f"expected keys w0..w{n_layers - 1}, b0..: got {sorted(params)}")

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls([t(params[f"w{i}"]) for i in range(n_layers)],
                   [t(params[f"b{i}"]) for i in range(n_layers)])

    def to_jax_params(self) -> dict[str, np.ndarray]:
        out = {}
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            out[f"w{i}"] = w.detach().cpu().numpy()
            out[f"b{i}"] = b.detach().cpu().numpy()
        return out

    @property
    def n_seeds(self) -> int:
        return int(self.weights[0].shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [M, d_in] -> [M, n_classes] mean over seeds of softmax(logits)."""
        h = x.unsqueeze(0).expand(self.n_seeds, *x.shape)
        return torch.softmax(apply_mlp_grid(self.weights, self.biases, h), dim=-1).mean(dim=0)
