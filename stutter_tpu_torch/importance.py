"""Permutation feature importance of the seed-ensembled MLP (counterpart of
stutter_tpu/importance.py).

The reference runs sklearn's permutation_importance with n_repeats=10
(main.py:976-989): 10 x n_features shuffled evaluations on the host.  Here
every (repeat, feature) variant of X is built on the model's device and
evaluated in chunks of [chunk, N, D] through the seed-batched forward.  The
permutations come from np.random.RandomState(seed) in the JAX package's
(repeat, feature) order, so the same weights give the JAX package's answer.
"""

from __future__ import annotations

import numpy as np
import torch

from stutter_tpu_torch.models.mlp import SeedMLP


@torch.no_grad()
def permutation_importance_tpu(
    fitted: SeedMLP,
    X: np.ndarray,
    y: np.ndarray,
    n_repeats: int = 10,
    seed: int = 42,
    eval_batch: int = 160,
) -> tuple[np.ndarray, np.ndarray]:
    """Accuracy-drop permutation importance on the model's device.

    Returns (mean [D], std [D]) over repeats, sklearn's
    permutation_importance(scoring=accuracy) semantics."""
    N, D = X.shape
    dev = fitted.weights[0].device
    rng = np.random.RandomState(seed)
    jobs = [(r, d) for r in range(n_repeats) for d in range(D)]
    perms = torch.as_tensor(np.stack([rng.permutation(N) for _ in jobs]), device=dev)
    cols = torch.as_tensor([d for _, d in jobs], device=dev)
    Xd = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    yd = torch.as_tensor(np.asarray(y, np.int64), device=dev)
    rows = torch.arange(N, device=dev)[None, :]

    def accuracy_of(Xv: torch.Tensor) -> torch.Tensor:  # [C, N, D] -> [C]
        probs = fitted(Xv.reshape(-1, D)).reshape(Xv.shape[0], N, -1)
        return (probs.argmax(-1) == yd).float().mean(-1)

    baseline = accuracy_of(Xd[None])
    accs = []
    for s in range(0, len(jobs), eval_batch):
        p, c = perms[s : s + eval_batch], cols[s : s + eval_batch, None]
        Xv = Xd.expand(len(p), N, D).clone()
        Xv[torch.arange(len(p), device=dev)[:, None], rows, c] = Xd[p, c]
        accs.append(accuracy_of(Xv))
    drops = (baseline - torch.cat(accs)).cpu().numpy().astype(np.float64)
    drops = drops.reshape(n_repeats, D)
    return drops.mean(axis=0), drops.std(axis=0)
