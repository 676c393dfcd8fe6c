"""Frozen copy of stutter_tpu_torch/models/layers.py (plain PyTorch), for the benchmark's reference.

Pieces the sequence heads share: XLA's 'SAME' padding, a parameter
store in the JAX package's names (and its stacked form, members of one
architecture side by side), and the masked mean pool.

XLA pads a stride-s, width-k 'SAME' convolution by
max((ceil(T / s) - 1) * s + k - T, 0) in total, the smaller half before:
(0, 1) for k = 3 and (1, 2) for k = 5 at an even T.  PyTorch's
`padding=k // 2` gives the same output length on a grid shifted by one,
so the heads pad explicitly with `F.pad`.

The stacked heads (the CNN, the transformer) run each convolution as
patches @ kernel, one batched product per layer (`conv_same_stacked`):
each member's result, forward and backward, is then the same whatever the
member count -- a grouped convolution's is not -- so a training grid's
entry trains as it would alone, and the kernels keep the JAX layout.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn



def same_pad(n: int, k: int, stride: int = 2) -> tuple[int, int]:
    """(low, high) padding of XLA's 'SAME' for length n, width k."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv1d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, C, T], w [O, C, k] -> [B, O, ceil(T / 2)], stride 2."""
    return F.conv1d(F.pad(x, same_pad(x.shape[-1], w.shape[-1])), w, stride=2)


def conv_same_stacked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each member's stride-2 'SAME' convolution over the spatial axes of
    channels-last x [M, B, *spatial, C] with its kernel in JAX's layout, w
    [M, *k, C, O] (HWIO, WIO) -> [M, B, *ceil(spatial / 2), O]."""
    M, B, *spatial, _ = x.shape
    ks = w.shape[1:-2]
    pad = []
    for n, k in reversed(list(zip(spatial, ks))):
        pad += same_pad(n, k)
    x = F.pad(x, (0, 0, *pad))
    for d, k in enumerate(ks):
        x = x.unfold(2 + d, k, 2)  # the window axes land last, after C
    x = x.movedim(2 + len(ks), -1)  # [M, B, *out, *k, C]
    out = x.shape[2 : 2 + len(ks)]
    y = torch.matmul(x.reshape(M, B, -1, w[0, ..., 0].numel()),
                     w.reshape(M, 1, -1, w.shape[-1]))
    return y.reshape(M, B, *out, w.shape[-1])


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x [..., B, T, D], mask [B, T] (or one per member, [M, B, T]) ->
    [..., B, D]: the mean over valid frames, the count clamped at 1 (the
    heads' pool)."""
    w = mask.to(x.dtype)[..., None]
    return (x * w).sum(-2) / torch.clamp_min(w.sum(-2), 1.0)


class Params(nn.Module):
    """A head's weights under the JAX package's names, in PyTorch's layout.

    `layouts` maps a pattern of names to the permutation from the JAX layout
    to PyTorch's (HWIO -> OIHW, WIO -> OIW); a name no pattern matches keeps
    its layout.  `lead` leading axes (the stacked members) stay in front."""

    layouts: dict[str, tuple[int, ...]] = {}
    lead = 0

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        self.p = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in params.items()})

    @classmethod
    def from_jax_params(cls, params: dict, device: torch.device | str = "cuda"):
        """From the JAX package's weights (numpy or JAX arrays), on `device`."""
        return cls(cls._to_torch(params, device))

    @classmethod
    def _perm(cls, name: str) -> tuple[int, ...] | None:
        for pattern, perm in cls.layouts.items():
            if re.fullmatch(pattern, name):
                return perm
        return None

    @classmethod
    def _to_torch(cls, params: dict, device) -> dict[str, torch.Tensor]:
        device = torch.device(device)
        out = {}
        for k, v in params.items():
            # a copy: a step on the module never writes into the caller's arrays
            t = torch.tensor(np.asarray(v, np.float32), device=device)
            perm = cls._perm(k)
            if perm is not None:
                t = t.permute(*range(cls.lead), *(cls.lead + i for i in perm)).contiguous()
            out[k] = t
        return out

class StackedParams(Params):
    """A head whose every weight carries a leading member axis [M, ...], so
    that members of one architecture with weights of the same shapes run
    as one batched forward: the serving vote's three transformer recipes,
    or the G entries of a training grid.  A single member is M = 1."""

    lead = 1

    @classmethod
    def from_jax_params(cls, params: dict, device: torch.device | str = "cuda"):
        """From one member's JAX weights (M = 1); `stack` joins members."""
        return super().from_jax_params({k: np.asarray(v, np.float32)[None]
                                        for k, v in params.items()}, device)

def member_mask(mask: torch.Tensor) -> torch.Tensor:
    """A frame mask shared by the members, [B, T], or one per member,
    [M, B, T] -> [1 or M, B, T]."""
    return mask[None] if mask.ndim == 2 else mask
