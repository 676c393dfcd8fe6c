"""StandardScaler / LabelEncoder in NumPy (counterpart of
stutter_tpu/models/scaler.py, which imports jax.numpy).

Same fields and array format as the JAX package's classes, so artifacts
saved by either package load in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StandardScaler:
    mean_: np.ndarray
    scale_: np.ndarray
    # raw variance and sample count, kept for a faithful sklearn export;
    # older saved scalers may lack them
    var_: np.ndarray | None = None
    n_samples_seen_: int | None = None

    @classmethod
    def fit(cls, X: np.ndarray) -> "StandardScaler":
        mean = X.mean(axis=0, dtype=np.float64)
        var = X.var(axis=0, dtype=np.float64)
        std = np.sqrt(var)
        # sklearn _handle_zeros_in_scale: zero variance -> scale 1
        scale = np.where(std == 0.0, 1.0, std)
        return cls(
            mean_=mean.astype(np.float32),
            scale_=scale.astype(np.float32),
            var_=var,
            n_samples_seen_=int(X.shape[0]),
        )

    def transform(self, X):
        return (X - self.mean_) / self.scale_

    def inverse_transform(self, X):
        return X * self.scale_ + self.mean_

    @property
    def n_features_in_(self) -> int:
        return int(self.mean_.shape[0])

    def to_arrays(self) -> dict:
        out = {"mean": self.mean_, "scale": self.scale_}
        if self.var_ is not None:
            out["var"] = self.var_
            out["n_samples"] = np.asarray(self.n_samples_seen_ or 0)
        return out

    @classmethod
    def from_arrays(cls, d: dict) -> "StandardScaler":
        return cls(
            mean_=np.asarray(d["mean"]),
            scale_=np.asarray(d["scale"]),
            var_=np.asarray(d["var"]) if "var" in d else None,
            n_samples_seen_=int(d["n_samples"]) if "n_samples" in d else None,
        )


@dataclasses.dataclass
class LabelEncoder:
    classes_: list[str]  # class names in label-index order

    @classmethod
    def fit(cls, labels: list[str]) -> "LabelEncoder":
        return cls(classes_=sorted(set(labels)))

    def transform(self, labels: list[str]) -> np.ndarray:
        index = {c: i for i, c in enumerate(self.classes_)}
        return np.array([index[l] for l in labels], dtype=np.int32)

    def fit_transform(self, labels: list[str]) -> np.ndarray:
        self.classes_ = sorted(set(labels))
        return self.transform(labels)

    def inverse_transform(self, y) -> list[str]:
        return [self.classes_[int(i)] for i in np.atleast_1d(np.asarray(y))]

    @property
    def n_classes(self) -> int:
        return len(self.classes_)
