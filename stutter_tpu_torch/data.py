"""Corpus discovery, labels and the feature-cache names (counterpart of
stutter_tpu/data.py; the parts the port's corpus and training paths use).

  * labels come from the parent directory name under segrigated_samples/
    (ref: pipeline1.py:372), or map into the 5-class dysfluency taxonomy
  * cached features are cache_features/<stem>_{raw|clean}_feats.npy,
    float32, shape (149,), keyed by STEM ONLY (ref: pipeline1.py:429-440);
    other feature lengths get a `_d<len>` tag, so the two packages share a
    workspace file for file
  * 16 of the reference's 905 stems occur in more than one class folder;
    the stem-keyed cache aliases those across classes (the first-written
    vector wins), and `find_stem_collisions` lists them
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np

from stutter_tpu_torch.config import DataConfig

# The 5-class dysfluency taxonomy from BASELINE.json's north star; the
# committed corpus covers three of these (its folder names map as below).
DYSFLUENCY_CLASSES_5 = ("repetition", "prolongation", "block", "interjection", "fluent")
CORPUS_LABEL_TO_5CLASS = {
    "word repetition": "repetition",
    "syllable repetition": "repetition",
    "Prolongatio sample": "prolongation",
}


def map_labels_to_5class(labels: list[str]) -> list[str]:
    """Corpus folder labels -> the 5-class taxonomy (unknown labels pass through)."""
    return [CORPUS_LABEL_TO_5CLASS.get(l, l) for l in labels]


def encode_labels(labels: list[str], taxonomy: str = "folder"):
    """(mapped_labels, LabelEncoder) for a label taxonomy.

    taxonomy='folder': classes are the corpus folder names (the reference's
    protocol, pipeline1.py:372).  taxonomy='5class': folder names map through
    CORPUS_LABEL_TO_5CLASS and the encoder covers the FULL 5-class dysfluency
    taxonomy, so trained heads have 5 outputs even when the corpus only
    exercises a subset; labels that map outside it are an error."""
    from stutter_tpu_torch.models.scaler import LabelEncoder

    if taxonomy == "folder":
        return labels, LabelEncoder.fit(labels)
    if taxonomy == "5class":
        mapped = map_labels_to_5class(labels)
        unknown = sorted(set(mapped) - set(DYSFLUENCY_CLASSES_5))
        if unknown:
            raise ValueError(
                f"labels not in the 5-class dysfluency taxonomy: {unknown}; "
                f"extend CORPUS_LABEL_TO_5CLASS or use taxonomy='folder'"
            )
        return mapped, LabelEncoder(classes_=sorted(DYSFLUENCY_CLASSES_5))
    raise ValueError(f"unknown label taxonomy {taxonomy!r}")


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


def find_stem_collisions(root: str) -> dict[str, list[str]]:
    """Stems that appear under more than one class folder (cache-aliasing hazard)."""
    seen: dict[str, set[str]] = {}
    for f in list_audio_files(root):
        seen.setdefault(Path(f).stem, set()).add(label_of(f))
    return {s: sorted(ls) for s, ls in seen.items() if len(ls) > 1}


def load_cached_corpus(
    data: DataConfig | None = None,
    root: str | None = None,
    suffixes: tuple[str, ...] = ("raw", "clean"),
    feature_len: int = 149,
) -> dict:
    """Walk the corpus and assemble X matrices from the feature cache.

    Mirrors the reference's training-data assembly (pipeline1.py:447-456):
    one row per audio file in sorted order; rows whose cache entry is missing
    get zeros (loaders that can decode should call the extractor for misses
    instead).

    Returns {"files": [...], "labels": [...], "X_<suffix>": np.ndarray,
    "missing_<suffix>": int}.
    """
    data = data or DataConfig()
    root = root or "."
    cache_dir = os.path.join(root, data.cache_dir)
    files = list_audio_files(os.path.join(root, data.data_dir), data.audio_exts)
    out: dict = {"files": files, "labels": [label_of(f) for f in files]}
    for suffix in suffixes:
        X = np.zeros((len(files), feature_len), np.float32)
        missing = 0
        for i, f in enumerate(files):
            p = cache_path(cache_dir, f, suffix)
            if os.path.exists(p):
                v = np.load(p)
                X[i, : min(len(v), feature_len)] = v[:feature_len]
            else:
                missing += 1
        out[f"X_{suffix}"] = X
        out[f"missing_{suffix}"] = missing
        if missing:
            logging.getLogger("stutter_tpu_torch.data").warning(
                "load_cached_corpus: %d/%d %r cache entries missing -- those "
                "rows are ZEROS; run `extract` (or drop them) before training",
                missing, len(files), suffix,
            )
    return out
