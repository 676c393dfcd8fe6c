"""Resumable training checkpoints (counterpart of
stutter_tpu/utils/checkpoint.py).

The reference's "checkpointing" is three layered filesystem caches (cleaned
WAVs, feature .npy, model pickles), kept by cache.py and persist.py.  This
module adds resumable TRAINING state -- the module's `state_dict()`, the
optimizer's `state_dict()` and the step -- so long sequence-model runs
survive preemption.  One `torch.save` file per step, `step_<n>.pt`, the
newest MAX_TO_KEEP kept (Orbax's max_to_keep=3 in the JAX package).

The format is the port's own: it cannot resume a checkpoint directory the
JAX package wrote through Orbax, nor Orbax one of these.
"""

from __future__ import annotations

import os
import re

import torch

MAX_TO_KEEP = 3
_NAME = re.compile(r"step_(\d+)\.pt")


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for n in os.listdir(ckpt_dir) if (m := _NAME.fullmatch(n)))


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.pt")


def save_train_state(ckpt_dir: str, step: int, params: dict, opt_state: dict) -> None:
    """Write step `step`'s state (written to a temporary name, then renamed:
    a crash mid-write leaves the earlier checkpoints whole), then delete all
    but the newest MAX_TO_KEEP."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = _path(ckpt_dir, step) + ".tmp"
    torch.save({"step": step, "params": params, "opt_state": opt_state}, tmp)
    os.replace(tmp, _path(ckpt_dir, step))
    for old in _steps(ckpt_dir)[:-MAX_TO_KEEP]:
        os.remove(_path(ckpt_dir, old))


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_train_state(ckpt_dir: str, step: int, device: torch.device | str = "cpu"
                        ) -> tuple[dict, dict]:
    """(params, opt_state) of step `step`, their tensors on `device`."""
    state = torch.load(_path(ckpt_dir, step), map_location=device, weights_only=True)
    return state["params"], state["opt_state"]
