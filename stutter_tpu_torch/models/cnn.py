"""CNN classifier over log-mel spectrograms (counterpart of
stutter_tpu/models/cnn.py).

Three stride-2 3x3 conv blocks over (time, mel) with bias, ReLU and a
per-channel gain; padded frames are zeroed before each conv and the mask
halves along time after it; a masked global average pool over (time, mel)
and a dense head.  Weights keep the JAX package's names; the conv kernels
are stored [out, in, kh, kw] (JAX: HWIO).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stutter_tpu_torch.models.layers import Params, same_pad


def init_cnn(
    rng: np.random.RandomState,
    n_mels: int = 128,
    channels: tuple = (32, 64, 96),
    n_classes: int = 3,
) -> dict[str, np.ndarray]:
    """Random weights in the JAX package's names, shapes and scales (HWIO
    kernels), drawn from a numpy generator."""
    params = {}
    c_in = 1
    for i, c_out in enumerate(channels):
        params[f"conv{i}"] = rng.randn(3, 3, c_in, c_out) * np.sqrt(2.0 / (9 * c_in))
        params[f"cb{i}"] = np.zeros(c_out)
        params[f"g{i}"] = np.ones(c_out)
        c_in = c_out
    params["w_out"] = rng.randn(c_in, n_classes) * np.sqrt(1.0 / c_in)
    params["b_out"] = np.zeros(n_classes)
    return {k: v.astype(np.float32) for k, v in params.items()}


class CNN(Params):
    layouts = {r"conv\d+": (3, 2, 0, 1)}  # HWIO -> OIHW

    def forward(self, spec: torch.Tensor, mask: torch.Tensor, n_valid=None) -> torch.Tensor:
        """spec [B, T, M] (standardized log-mel), mask [B, T] -> logits [B, C]."""
        x = spec[:, None]  # [B, 1, T, M]
        n_blocks = sum(1 for k in self.p if k.startswith("conv"))
        for i in range(n_blocks):
            x = x * mask.to(x.dtype)[:, None, :, None]
            (t0, t1), (m0, m1) = same_pad(x.shape[2], 3), same_pad(x.shape[3], 3)
            x = F.conv2d(F.pad(x, (m0, m1, t0, t1)), self.p[f"conv{i}"], stride=2)
            x = torch.relu(x + self.p[f"cb{i}"][:, None, None]) * self.p[f"g{i}"][:, None, None]
            mask = mask[:, ::2]
        # masked global average pool over (time, mel): the count is the
        # valid frames times the downsampled mel width
        w = mask.to(x.dtype)[:, None, :, None]
        pooled = (x * w).sum((2, 3)) / torch.clamp_min(w.sum((2, 3)) * x.shape[3], 1.0)
        return pooled @ self.p["w_out"] + self.p["b_out"]
