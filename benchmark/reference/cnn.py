"""Frozen copy of stutter_tpu_torch/models/cnn.py (plain PyTorch), for the benchmark's reference.

CNN classifier over log-mel spectrograms (counterpart of
stutter_tpu/models/cnn.py).

Three stride-2 3x3 conv blocks over (time, mel) with bias, ReLU and a
per-channel gain; padded frames are zeroed before each conv and the mask
halves along time after it; a masked global average pool over (time, mel)
and a dense head.  Weights keep the JAX package's names and layouts (HWIO
conv kernels).

Like the transformer, every weight carries a leading member axis [M, ...]:
M heads of this shape (a training grid's entries) run as one forward, each
conv a batched patches @ kernel product.  A single member is M = 1.
"""

from __future__ import annotations

import torch

from .layers import StackedParams, conv_same_stacked, member_mask


class CNN(StackedParams):
    def forward(self, spec: torch.Tensor, mask: torch.Tensor, n_valid=None) -> torch.Tensor:
        """spec [M, B, T, F] (each member's standardized log-mel), mask [B, T]
        or one per member [M, B, T] -> logits [M, B, C]; for M = 1 also
        spec [B, T, F] -> [B, C]."""
        if spec.ndim == 3:
            return self.forward(spec[None], mask)[0]
        m = member_mask(mask)  # [1 or M, B, T]
        x = spec[..., None]  # [M, B, T, F, C = 1]
        n_blocks = sum(1 for k in self.p if k.startswith("conv"))
        for i in range(n_blocks):
            x = x * m.to(x.dtype)[..., None, None]
            x = conv_same_stacked(x, self.p[f"conv{i}"])
            x = (torch.relu(x + self.p[f"cb{i}"][:, None, None, None])
                 * self.p[f"g{i}"][:, None, None, None])
            m = m[..., ::2]
        # masked global average pool over (time, mel): the count is the
        # valid frames times the downsampled mel width
        w = m.to(x.dtype)[..., None, None]
        pooled = (x * w).sum((2, 3)) / torch.clamp_min(w.sum((2, 3)) * x.shape[3], 1.0)
        return torch.matmul(pooled, self.p["w_out"]) + self.p["b_out"][:, None]
