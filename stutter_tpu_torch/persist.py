"""Artifact persistence (counterpart of stutter_tpu/persist.py), NumPy only.

Reads and writes the same files as the JAX package, so artifacts trained
there serve here unchanged:
  model_mlp_tpu.npz / .json   stacked MLP params (w{i}, b{i}) + meta
  scaler_after.npz            StandardScaler arrays
  label_encoder.json          {"classes": [...]}
  model_<arch>.npz            a sequence head's params (flattened names)
  model_<arch>_norm.npz       its per-feature mean / std
  model_<arch>.json           {"arch", "classes", "kind"}
  <name>.npz                  a WavLM encoder's weights under the
                              checkpoint's parameter names (save_wavlm)
and, where sklearn and joblib are installed, the reference's pickles
(scaler_after.pkl, label_encoder.pkl, model_rf.pkl).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.models.mlp import SeedMLP
from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler


def _flatten_params(params: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten_params(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def _unflatten_params(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_seq_head(output_dir: str, arch: str) -> tuple[dict, np.ndarray, np.ndarray, dict]:
    """The model_<arch>.npz / _norm.npz / .json trio -> (params as numpy in
    the JAX layout, mean, std, metadata)."""
    with np.load(os.path.join(output_dir, f"model_{arch}.npz")) as z:
        params = _unflatten_params(dict(z))
    with np.load(os.path.join(output_dir, f"model_{arch}_norm.npz")) as z:
        mean, std = z["mean"], z["std"]
    meta = json.loads(Path(output_dir, f"model_{arch}.json").read_text())
    return params, mean, std, meta


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


def save_wavlm(path: str | Path, params: dict) -> None:
    """A WavLM encoder's weights (models/wavlm.py: name -> tensor, the
    checkpoint's names) as one .npz, float32."""
    np.savez(str(path), **{k: v.detach().cpu().numpy().astype(np.float32)
                           for k, v in params.items()})


def load_wavlm(path: str | Path, cfg, device: torch.device | str = "cuda") -> dict:
    """The .npz of save_wavlm -> {name: tensor on `device`}; raises unless
    it holds exactly the parameters of `cfg` (a WavLMConfig), shape for
    shape."""
    from stutter_tpu_torch.models.wavlm import param_shapes

    device = resolve_device(device)
    shapes = param_shapes(cfg)
    with np.load(str(path)) as z:
        got = {k: tuple(z[k].shape) for k in z.files}
        if got != shapes:
            diff = sorted(set(got.items()) ^ set(shapes.items()))[:4]
            raise ValueError(f"{path}: parameters differ from the config's, e.g. {diff}")
        return {k: torch.as_tensor(z[k], dtype=torch.float32, device=device) for k in shapes}


def save_scaler(path: str | Path, scaler: StandardScaler) -> None:
    np.savez(str(path), **scaler.to_arrays())


def load_scaler(path: str | Path) -> StandardScaler:
    with np.load(str(path)) as z:
        return StandardScaler.from_arrays(dict(z))


def save_label_encoder(path: str | Path, le: LabelEncoder) -> None:
    Path(path).write_text(json.dumps({"classes": le.classes_}))


def load_label_encoder(path: str | Path) -> LabelEncoder:
    return LabelEncoder(classes_=json.loads(Path(path).read_text())["classes"])


def to_sklearn_scaler(scaler: StandardScaler):
    """The fitted state as a real sklearn StandardScaler, so reference code
    can `joblib.load('scaler_after.pkl').transform(X)` unchanged (ref
    consumers: main1.py:983-987)."""
    from sklearn.preprocessing import StandardScaler as SkScaler

    sk = SkScaler()
    mean = np.asarray(scaler.mean_, np.float64)
    scale = np.asarray(scaler.scale_, np.float64)
    sk.mean_ = mean
    sk.scale_ = scale
    # var_ is the RAW variance (0 where scale_ was clamped to 1); fall back to
    # scale_**2 for scalers saved before var_ was tracked.
    sk.var_ = np.asarray(scaler.var_, np.float64) if scaler.var_ is not None else scale**2
    sk.n_features_in_ = mean.shape[0]
    sk.n_samples_seen_ = int(scaler.n_samples_seen_ or 0)
    return sk


def to_sklearn_label_encoder(le: LabelEncoder):
    """Export as a real sklearn LabelEncoder (classes_ must be an ndarray)."""
    from sklearn.preprocessing import LabelEncoder as SkLE

    sk = SkLE()
    sk.classes_ = np.asarray(le.classes_, dtype=object)
    return sk


def save_sklearn_artifacts(output_dir: str, scaler=None, le=None, rf=None) -> None:
    """Reference-compatible pickles (ref filenames, main.py:889-890, 948):
    scaler_after.pkl, label_encoder.pkl, model_rf.pkl.  The port's scaler
    and label encoder are converted to genuine sklearn estimators first.
    Skipped silently where joblib is not installed, as in the JAX package."""
    try:
        import joblib
    except ImportError:
        return
    os.makedirs(output_dir, exist_ok=True)
    if scaler is not None:
        if isinstance(scaler, StandardScaler):
            scaler = to_sklearn_scaler(scaler)
        joblib.dump(scaler, os.path.join(output_dir, "scaler_after.pkl"))
    if le is not None:
        if isinstance(le, LabelEncoder):
            le = to_sklearn_label_encoder(le)
        joblib.dump(le, os.path.join(output_dir, "label_encoder.pkl"))
    if rf is not None:
        joblib.dump(rf, os.path.join(output_dir, "model_rf.pkl"))


def clear_stale_artifacts(output_dir: str) -> None:
    """Delete stale model pickles at startup (ref: main1.py:795-799) so
    feature-shape drift fails loudly instead of misclassifying."""
    for name in ("model_rf.pkl", "scaler_after.pkl", "label_encoder.pkl"):
        p = os.path.join(output_dir, name)
        if os.path.exists(p):
            os.unlink(p)
