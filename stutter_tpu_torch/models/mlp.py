"""Seed-ensembled MLP classifier head (counterpart of stutter_tpu/models/mlp.py
and the predict side of stutter_tpu/train/trainer.py: predict_proba_grid,
FittedMLP).

The JAX package trains S seeds of one MLP as a stacked pytree (seed axis
first) and predicts with the mean over seeds of the softmax.  `SeedMLP`
holds the same stacked weights, [S, d_in, d_out] and [S, d_out] per layer,
and runs all seeds as one batched product per layer.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


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
        cls, params: dict[str, np.ndarray], device: torch.device | str = "cpu"
    ) -> "SeedMLP":
        """From the JAX pytree {w0, b0, w1, b1, ...}, seed axis first."""
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
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            h = torch.baddbmm(b.unsqueeze(1), h, w)
            if i < last:
                h = torch.relu(h)
        return torch.softmax(h, dim=-1).mean(dim=0)
