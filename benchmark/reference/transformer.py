"""Frozen copy of stutter_tpu_torch/models/transformer.py (plain PyTorch), for the benchmark's reference.

Transformer encoder classifier over log-mel spectrograms (counterpart of
stutter_tpu/models/transformer.py), for one member or several stacked.

A conv stem of two stride-2 width-5 1-D convs (n_mels -> d -> d, ReLU),
sinusoidal positions built in float32, pre-LN blocks (4 heads; padded keys
masked with -1e9; tanh GELU; layer norm with the biased variance and eps
1e-6), a final layer norm, a masked mean pool and a dense head.

Every weight carries a leading member axis [M, ...], so members of this
architecture with weights of the same shapes (the quint's three
transformer recipes, a training grid's entries) run as one batched
forward: the stem and the blocks as batched products -- the counterpart of
the JAX package's vmapped stack (stutter_tpu/infer.py:_member_forwards).
A single member is M = 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import (StackedParams, conv_same_stacked, masked_mean,
                                              member_mask)

N_HEADS = 4


def sin_pos(T: int, D: int, device) -> torch.Tensor:
    """Fixed sinusoidal positions [T, D], computed in float32."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    half = D // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=device)
                     / half)
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class Transformer(StackedParams):
    def _layernorm(self, x, name):
        g, b = self.p[f"{name}_g"], self.p[f"{name}_b"]
        return F.layer_norm(x, x.shape[-1:], eps=1e-6) * g[:, None, None] + b[:, None, None]

    def _dense(self, x, name):
        return torch.matmul(x, self.p[name][:, None])

    def forward(self, spec: torch.Tensor, mask: torch.Tensor, n_valid=None) -> torch.Tensor:
        """spec [M, B, T, n_mels] (each member's standardized log-mel), mask
        [B, T] or one per member [M, B, T] -> logits [M, B, C]; for M = 1
        also spec [B, T, n_mels] -> [B, C]."""
        if spec.ndim == 3:
            return self.forward(spec[None], mask)[0]
        M, B = spec.shape[:2]
        mask = member_mask(mask)  # [1 or M, B, T]
        x = spec
        for i in range(2):
            x = x * mask.to(x.dtype)[..., None]
            x = conv_same_stacked(x, self.p[f"stem{i}"])  # [M, B, T', d]
            x = torch.relu(x + self.p[f"stem{i}_b"][:, None, None])
            mask = mask[..., ::2]

        T, D = x.shape[2:]
        H, dh = N_HEADS, D // N_HEADS
        x = x + sin_pos(T, D, x.device)
        keep = mask[:, :, None, None, :]  # padded keys leave every row
        n_blocks = sum(1 for k in self.p if k.endswith("_wq"))
        for i in range(n_blocks):
            h = self._layernorm(x, f"blk{i}_ln1")
            q, k, v = (self._dense(h, f"blk{i}_{n}").reshape(M, B, T, H, dh).transpose(2, 3)
                       for n in ("wq", "wk", "wv"))  # [M, B, H, T, dh]
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
            att = torch.softmax(torch.where(keep, scores, -1e9), dim=-1)
            o = torch.matmul(att, v).transpose(2, 3).reshape(M, B, T, D)
            x = x + self._dense(o, f"blk{i}_wo")
            h = self._layernorm(x, f"blk{i}_ln2")
            h = F.gelu(self._dense(h, f"blk{i}_ff1") + self.p[f"blk{i}_ff1_b"][:, None, None],
                       approximate="tanh")
            x = x + (self._dense(h, f"blk{i}_ff2") + self.p[f"blk{i}_ff2_b"][:, None, None])

        x = self._layernorm(x, "ln_f")
        return torch.matmul(masked_mean(x, mask), self.p["w_out"]) + self.p["b_out"][:, None]
