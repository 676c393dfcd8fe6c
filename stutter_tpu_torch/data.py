"""Corpus discovery, labels and the feature-cache names (counterpart of
stutter_tpu/data.py; the parts the port's corpus path uses).

  * labels come from the parent directory name under segrigated_samples/
    (ref: pipeline1.py:372)
  * cached features are cache_features/<stem>_{raw|clean}_feats.npy,
    float32, shape (149,), keyed by STEM ONLY (ref: pipeline1.py:429-440);
    other feature lengths get a `_d<len>` tag, so the two packages share a
    workspace file for file.
"""

from __future__ import annotations

import os
from pathlib import Path


def list_audio_files(root: str, exts=(".wav", ".mp3", ".flac", ".m4a", ".ogg")) -> list[str]:
    """Recursive, extension-filtered, sorted (ref: pipeline1.py:91-97)."""
    files = []
    for r, _, fs in os.walk(root):
        for f in fs:
            if f.lower().endswith(tuple(exts)):
                files.append(os.path.join(r, f))
    return sorted(files)


def label_of(path: str) -> str:
    """Class label = parent directory name (ref: pipeline1.py:372)."""
    return os.path.basename(os.path.dirname(path)) or "unknown"


def cache_path(cache_dir: str, audio_path: str, suffix: str, feature_len: int = 149) -> str:
    """cache_features/<stem>_{raw|clean}_feats.npy (ref: pipeline1.py:431-432).

    The exact reference filename is reserved for the canonical 149-dim
    contract; other variants (the 286-dim main.py geometry) get a
    length-tagged name so regenerating one variant never clobbers the
    entries of another.
    """
    stem = Path(audio_path).stem
    tag = "" if feature_len == 149 else f"_d{feature_len}"
    return os.path.join(cache_dir, f"{stem}_{suffix}_feats{tag}.npy")
