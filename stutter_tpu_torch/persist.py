"""Artifact persistence (counterpart of stutter_tpu/persist.py), NumPy only.

Reads and writes the same files as the JAX package, so artifacts trained
there serve here unchanged:
  model_mlp_tpu.npz / .json   stacked MLP params (w{i}, b{i}) + meta
  scaler_after.npz            StandardScaler arrays
  label_encoder.json          {"classes": [...]}
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from stutter_tpu_torch.models.mlp import SeedMLP
from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler


def save_mlp(path: str | Path, model: SeedMLP) -> None:
    """<path>.npz (params) + <path>.json (n_seeds, hidden, n_classes)."""
    path = str(path)
    params = model.to_jax_params()
    np.savez(path + ".npz", **params)
    n = len(params) // 2
    meta = {
        "n_seeds": model.n_seeds,
        "hidden": [int(params[f"w{i}"].shape[-1]) for i in range(n - 1)],
        "n_classes": int(params[f"w{n - 1}"].shape[-1]),
    }
    Path(path + ".json").write_text(json.dumps(meta))


def load_mlp(path: str | Path, device: torch.device | str = "cuda") -> SeedMLP:
    """<path>.npz + <path>.json -> the SeedMLP on `device`."""
    path = str(path)
    with np.load(path + ".npz") as z:
        params = dict(z)
    meta = json.loads(Path(path + ".json").read_text())
    model = SeedMLP.from_jax_params(params, device=device)
    widths = [int(w.shape[-1]) for w in model.weights]
    if model.n_seeds != meta["n_seeds"] or widths != [*meta["hidden"], meta["n_classes"]]:
        raise ValueError(f"{path}: params {widths} x {model.n_seeds} seeds disagree with {meta}")
    return model


def save_scaler(path: str | Path, scaler: StandardScaler) -> None:
    np.savez(str(path), **scaler.to_arrays())


def load_scaler(path: str | Path) -> StandardScaler:
    with np.load(str(path)) as z:
        return StandardScaler.from_arrays(dict(z))


def save_label_encoder(path: str | Path, le: LabelEncoder) -> None:
    Path(path).write_text(json.dumps({"classes": le.classes_}))


def load_label_encoder(path: str | Path) -> LabelEncoder:
    return LabelEncoder(classes_=json.loads(Path(path).read_text())["classes"])
