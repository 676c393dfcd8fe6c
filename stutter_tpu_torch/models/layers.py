"""Pieces the sequence heads share: XLA's 'SAME' padding, a parameter
store in the JAX package's names, and the masked mean pool.

XLA pads a stride-s, width-k 'SAME' convolution by
max((ceil(T / s) - 1) * s + k - T, 0) in total, the smaller half before:
(0, 1) for k = 3 and (1, 2) for k = 5 at an even T.  PyTorch's
`padding=k // 2` gives the same output length on a grid shifted by one,
so the heads pad explicitly with `F.pad`.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stutter_tpu_torch.device import resolve_device


def same_pad(n: int, k: int, stride: int = 2) -> tuple[int, int]:
    """(low, high) padding of XLA's 'SAME' for length n, width k."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv1d_same(x: torch.Tensor, w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """x [B, C, T], w [O, C / groups, k] -> [B, O, ceil(T / 2)], stride 2."""
    return F.conv1d(F.pad(x, same_pad(x.shape[-1], w.shape[-1])), w, stride=2, groups=groups)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x [..., B, T, D], mask [B, T] -> [..., B, D]: the mean over valid
    frames, the count clamped at 1 (the heads' pool)."""
    w = mask.to(x.dtype)[:, :, None]
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
        device = resolve_device(device)
        out = {}
        for k, v in params.items():
            # a copy: a step on the module never writes into the caller's arrays
            t = torch.tensor(np.asarray(v, np.float32), device=device)
            perm = cls._perm(k)
            if perm is not None:
                t = t.permute(*range(cls.lead), *(cls.lead + i for i in perm)).contiguous()
            out[k] = t
        return out

    def to_jax_params(self) -> dict[str, np.ndarray]:
        """The weights in the JAX package's names and layout, as numpy."""
        out = {}
        for k, v in self.p.items():
            perm = self._perm(k)
            if perm is not None:
                inv = tuple(int(i) for i in np.argsort(perm))
                v = v.permute(*range(self.lead), *(self.lead + i for i in inv))
            out[k] = v.detach().cpu().numpy()
        return out
