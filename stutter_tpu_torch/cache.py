"""Feature cache with the reference's .npy naming/shape contract
(counterpart of stutter_tpu/cache.py).

Ref: pipeline1.py:429-440 / main.py:665-672.  Contract:
  cache_features/<stem>_{raw|clean}_feats.npy, float32, shape (149,)
keyed by STEM ONLY, a known aliasing hazard when the same stem appears under
several class folders.  Writes are atomic (tmp + rename), an entry of
another shape is never overwritten, and stem collisions are logged.
"""

from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path

import numpy as np

from stutter_tpu_torch.data import cache_path


class FeatureCache:
    def __init__(self, cache_dir: str, feature_len: int = 149, warn_collisions: bool = True):
        self.cache_dir = cache_dir
        self.feature_len = feature_len
        self._seen_stems: dict[str, str] = {}
        self.warn_collisions = warn_collisions
        os.makedirs(cache_dir, exist_ok=True)

    def path_for(self, audio_path: str, suffix: str) -> str:
        return cache_path(self.cache_dir, audio_path, suffix, self.feature_len)

    def load(self, audio_path: str, suffix: str) -> np.ndarray | None:
        """Silent-None on missing/corrupt entries (ref: pipeline1.py:117-121)."""
        p = self.path_for(audio_path, suffix)
        try:
            v = np.load(p)
        except Exception:
            return None
        return np.asarray(v)

    def store(self, audio_path: str, suffix: str, feats: np.ndarray) -> str:
        """Atomic write preserving the reference's filename/shape/dtype contract."""
        feats = np.asarray(feats, np.float32)
        if feats.shape != (self.feature_len,):
            raise ValueError(f"feature shape {feats.shape} != ({self.feature_len},)")
        stem = Path(audio_path).stem
        prev = self._seen_stems.get(stem)
        parent = os.path.basename(os.path.dirname(audio_path))
        if prev is not None and prev != parent and self.warn_collisions:
            logging.warning(
                "feature-cache stem collision: %r seen under %r and %r "
                "(stem-keyed cache aliases across classes; ref pipeline1.py:429-440)",
                stem, prev, parent,
            )
        self._seen_stems[stem] = parent
        p = self.path_for(audio_path, suffix)
        # an existing entry of another shape means variant mixing or
        # corruption: never destroy it silently
        if os.path.exists(p):
            try:
                existing = np.load(p)
            except Exception:
                existing = None
            if existing is not None and existing.shape != feats.shape:
                raise ValueError(
                    f"refusing to overwrite {p}: existing shape {existing.shape} "
                    f"!= new {feats.shape} (feature-variant mismatch?)"
                )
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".npy.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, feats)
            os.replace(tmp, p)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return p

    def get_or_compute(self, audio_path: str, suffix: str, compute) -> np.ndarray:
        """cached_extract semantics (ref: main.py:665-672): the cached entry
        when there is one, else `compute()` stored and returned."""
        cached = self.load(audio_path, suffix)
        if cached is not None:
            return cached
        feats = np.asarray(compute(), np.float32)
        self.store(audio_path, suffix, feats)
        return feats
