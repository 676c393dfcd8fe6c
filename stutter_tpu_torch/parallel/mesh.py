"""Data parallelism over a mesh of devices (counterpart of
stutter_tpu/parallel/mesh.py).

A mesh is an ordered tuple of indexed torch devices, driven by one
controller process as the JAX package's 1-D `data` mesh is.  Work that is
independent per clip (the front end, the gate, the sequence vote) is cut
into contiguous shards along the batch, one per mesh device; every shard is
uploaded, then every shard launched, before any result is read back, so the
devices run at once; the results come back to the host in mesh order.  The
data-parallel MLP step keeps the parameters replicated and the batch
sharded, sums the shards' gradients on the first device in mesh order (the
JAX package's psum), makes one optimizer update there and broadcasts it.

A mesh may name one device more than once: the CPU tests run
make_mesh(devices=["cpu"] * 8), and one card runs a split into two shards
on itself (which checks the split and the gather, not two devices).
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import numpy as np
import torch

from stutter_tpu_torch.device import resolve_device, visible_gpus


def _indexed(dev: torch.device) -> torch.device:
    """An unindexed `cuda` is whichever device is current: pin it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, *, devices=None) -> tuple[torch.device, ...]:
    """The first `n_devices` visible GPUs (all of them by default), or the
    given `devices` in their order (a device may repeat) -> the mesh, each
    device indexed.  Raises without a GPU when one is asked for."""
    if devices is None:
        devs = visible_gpus()
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"a mesh of {n_devices} devices asked for; "
                                 f"{len(devs)} GPUs are visible")
            devs = devs[:n_devices]
    else:
        devs = [_indexed(resolve_device(d)) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return tuple(devs)


def resolve_mesh(mesh=None, device: torch.device | str = "cuda") -> tuple[torch.device, ...]:
    """The mesh an entry point runs on: `mesh` (make_mesh's `devices`) when
    given; else every visible GPU for an unindexed `cuda`, or the one device
    asked for (`cpu`, `cuda:1`)."""
    if mesh is not None:
        return make_mesh(devices=mesh)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh()
    return (dev,)


def grid_shards(n: int, mesh) -> list[tuple[torch.device, slice]]:
    """n grid entries cut into k contiguous slices, slice i for mesh[i], k
    the largest divisor of n not above the mesh's size (no padding, as the
    JAX package's shard_grid)."""
    k = min(len(mesh), n)
    while n % k:
        k -= 1
    m = n // k
    return [(mesh[i], slice(i * m, (i + 1) * m)) for i in range(k)]


def shard_batch(mesh, *arrays):
    """Each array (numpy or tensor, batch first) cut into len(mesh)
    contiguous shards, shard i on mesh[i] -> a list of shards per array (the
    list itself for one array).  The batch must divide the mesh."""
    n = len(mesh)
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        if a.shape[0] % n:
            raise ValueError(f"a batch of {a.shape[0]} does not divide a mesh of {n}")
        b = a.shape[0] // n
        out.append([a[i * b : (i + 1) * b].to(d) for i, d in enumerate(mesh)])
    return tuple(out) if len(out) > 1 else out[0]


def _to(tree, dev: torch.device):
    if isinstance(tree, torch.nn.Module):
        own = next(tree.parameters()).device
        return tree if own == dev else copy.deepcopy(tree).to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev, copy=True)
    return torch.tensor(np.asarray(tree), device=dev)


def replicate(mesh, tree) -> list:
    """One copy of `tree` per mesh device, in mesh order: a tensor or numpy
    array (always copied, so an update of a replica in place never reaches
    the caller's array), a dict of them, or an nn.Module for inference
    (deep-copied to each device but its own, where the module itself
    serves)."""
    return [_to(tree, d) for d in mesh]


def extract_features_sharded(mesh, audio, lengths, **kw) -> np.ndarray:
    """The 149-dim front end (ops.frontend.extract_features_149_batch, its
    kernels on each CUDA device) over the mesh: audio [B, N], lengths [B]
    (numpy or tensors; B a multiple of the mesh's size) -> [B, 149] on the
    host.  kw passes through to the extractor."""
    from stutter_tpu_torch.ops.frontend import extract_features_149_batch, gather, launch_shards

    fn = functools.partial(extract_features_149_batch, **kw)
    return gather(launch_shards(fn, shard_batch(mesh, audio, lengths)))


def denoise_sharded(mesh, audio, lengths, cfg=None) -> np.ndarray:
    """The spectral gate (denoise.denoise_batch, the gate kernel on each
    CUDA device) over the mesh: audio [B, N], lengths [B] -> the denoised,
    peak-normalised [B, N] on the host."""
    from stutter_tpu_torch.config import DenoiseConfig
    from stutter_tpu_torch.denoise import denoise_batch
    from stutter_tpu_torch.ops.frontend import gather, launch_shards

    fn = functools.partial(denoise_batch, cfg=cfg if cfg is not None else DenoiseConfig())
    return gather(launch_shards(fn, shard_batch(mesh, audio, lengths)))


def _smoothed_ce_sum(logits: torch.Tensor, y: torch.Tensor, n_classes: int,
                     label_smoothing: float) -> torch.Tensor:
    """sum over rows of optax.softmax_cross_entropy against
    optax.smooth_labels(one_hot(y), a)."""
    targets = (torch.nn.functional.one_hot(y.long(), n_classes).to(logits.dtype)
               * (1.0 - label_smoothing) + label_smoothing / n_classes)
    return -(targets * torch.log_softmax(logits, dim=-1)).sum()


class DPTrainStep:
    """make_dp_train_step's step: `step(params, xb, yb) -> (params, loss)`.

    params are the replicas (replicate's list, one dict of the MLP's
    tensors in the JAX package's names per mesh device); the first device's
    copy is the master, which the optimizer -- make_opt(its tensors), made
    at the first call and kept as `optimizer` -- updates in place.  xb, yb
    are shard_batch's shards.  Each device's summed loss and gradients
    (torch.autograd.grad: a replica that shares the master's tensors on a
    repeated device gathers no gradient into them) are copied to the first
    device and summed in mesh order, divided by the global row count, and
    the update is broadcast -> the new replicas and the mean loss there."""

    def __init__(self, mesh, make_opt, n_classes: int = 3, label_smoothing: float = 0.05):
        self.mesh, self.make_opt = tuple(mesh), make_opt
        self.n_classes, self.label_smoothing = n_classes, label_smoothing
        self.optimizer = None

    def __call__(self, params: list, xb: list, yb: list):
        from stutter_tpu_torch.models.mlp import apply_mlp

        master, dev0 = params[0], self.mesh[0]
        if self.optimizer is None:
            for t in master.values():
                t.requires_grad_(True)
            self.optimizer = self.make_opt(list(master.values()))
        sums, grads = [], []
        for i, (p, x, y) in enumerate(zip(params, xb, yb)):
            leaves = (list(master.values()) if i == 0
                      else [t.detach().requires_grad_(True) for t in p.values()])
            loss = _smoothed_ce_sum(apply_mlp(dict(zip(p, leaves)), x), y, self.n_classes,
                                    self.label_smoothing)
            grads.append(torch.autograd.grad(loss, leaves))
            sums.append(loss.detach())
        n_total = sum(len(y) for y in yb)
        for j, t in enumerate(master.values()):
            g = grads[0][j]
            for gi in grads[1:]:
                g = g + gi[j].to(dev0)
            t.grad = g / n_total
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        loss = sums[0]
        for s in sums[1:]:
            loss = loss + s.to(dev0)
        with torch.no_grad():
            replicas = [master] + [{k: t.detach().to(d) for k, t in master.items()}
                                   for d in self.mesh[1:]]
        return replicas, loss / n_total


def make_dp_train_step(mesh, make_opt, n_classes: int = 3,
                       label_smoothing: float = 0.05) -> DPTrainStep:
    """A data-parallel MLP step over the mesh: params replicated, batch
    sharded, the gradients reduced on the first device (DPTrainStep)."""
    return DPTrainStep(mesh, make_opt, n_classes, label_smoothing)


def dp_eval_accuracy(mesh, params: list, X: np.ndarray, y: np.ndarray) -> float:
    """The share of rows whose argmax is their label: X, y sharded over the
    mesh, params replicated (replicate's list); the per-device counts
    summed on the first device."""
    from stutter_tpu_torch.models.mlp import apply_mlp

    xb, yb = shard_batch(mesh, np.asarray(X, np.float32), np.asarray(y, np.int64))
    with torch.no_grad():
        counts = [(apply_mlp(p, x).argmax(-1) == t).sum() for p, x, t in zip(params, xb, yb)]
    total = counts[0]
    for c in counts[1:]:
        total = total + c.to(mesh[0])
    return float(total) / len(y)


def train_mlp_dp(
    mesh,
    X: np.ndarray,
    y: np.ndarray,
    n_classes: int = 3,
    epochs: int = 100,
    batch_size: int = 256,
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-4,
    seed: int = 42,
    hidden: tuple = (256, 128, 64),
    *,
    init: dict | None = None,
) -> dict[str, torch.Tensor]:
    """Data-parallel training of one MLP over the mesh -> its weights in
    the JAX package's names, on the first device.

    As the JAX package's train_mlp_dp: the batch rounded down to a multiple
    of the mesh's size (at least one row a device), max(1, N // batch) *
    epochs steps, each of rows drawn with replacement by
    np.random.RandomState(seed).randint; add_decayed_weights + Adam under
    the cosine schedule (train/trainer.py's header).  The weights start
    from `init` (JAX-layout arrays) or init_mlp(seed)."""
    from stutter_tpu_torch.models.mlp import init_mlp
    from stutter_tpu_torch.train.trainer import MLPTrainConfig
    from stutter_tpu_torch.train.trainer import learning_rate as cosine_rate

    n_dev = len(mesh)
    batch_size = max(batch_size // n_dev, 1) * n_dev
    N, D = X.shape
    steps = max(1, N // batch_size) * epochs
    schedule = MLPTrainConfig(learning_rate=learning_rate)
    init = init if init is not None else init_mlp(seed, D, hidden, n_classes)
    params = replicate(mesh, {k: np.asarray(v, np.float32) for k, v in init.items()})
    step = make_dp_train_step(mesh, lambda ps: torch.optim.Adam(
        ps, lr=learning_rate, weight_decay=weight_decay), n_classes)
    X, y = np.asarray(X, np.float32), np.asarray(y, np.int64)
    rng = np.random.RandomState(seed)
    for s in range(steps):
        idx = rng.randint(0, N, batch_size)
        params, _ = step(params, *shard_batch(mesh, X[idx], y[idx]))
        for group in step.optimizer.param_groups:
            group["lr"] = cosine_rate(s + 1, steps, schedule)
    return {k: t.detach() for k, t in params[0].items()}


def ensemble_sharded(
    mesh,
    audio,
    lengths,
    members: list,
    *,
    dn_cfg=None,
    denoise: bool = True,
    t_max: int = 316,
    sr: int = 16000,
) -> np.ndarray:
    """The sequence members' vote over the mesh: each device runs the whole
    request path (infer._ensemble_fused: the gate at the batch's N, one
    spectrogram, every member forward) on its shard of the clips, with the
    members' forward groups replicated.  audio [B, N], lengths [B] (B a
    multiple of the mesh's size), members: SeqPredictors in the vote's
    order -> [M, B, C] member probabilities on the host."""
    from stutter_tpu_torch.config import DenoiseConfig
    from stutter_tpu_torch.infer import _ensemble_fused, _member_groups

    cfg = dn_cfg if dn_cfg is not None else DenoiseConfig()
    groups = _member_groups(list(members))
    lens = np.asarray(lengths, np.int64)
    audio_sh, len_sh = shard_batch(mesh, audio, lens)
    b = len(lens) // len(mesh)
    outs = []
    for i, (d, a, n) in enumerate(zip(mesh, audio_sh, len_sh)):
        local = [dataclasses.replace(g, model=_to(g.model, d), mean=g.mean.to(d), std=g.std.to(d))
                 for g in groups]
        outs.append(_ensemble_fused(a, n, lens[i * b : (i + 1) * b], local, len(members), cfg,
                                    denoise, sr, t_max))
    return np.concatenate([o.cpu().numpy() for o in outs], axis=1)
