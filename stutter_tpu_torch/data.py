"""Corpus discovery, labels and the feature-cache names (counterpart of
stutter_tpu/data.py; the parts the port's corpus and training paths use).

  * labels come from the parent directory name under segrigated_samples/
    (ref: pipeline1.py:372), or map into the 5-class dysfluency taxonomy
  * cached features are cache_features/<stem>_{raw|clean}_feats.npy,
    float32, shape (149,), keyed by STEM ONLY (ref: pipeline1.py:429-440);
    other feature lengths get a `_d<len>` tag, so the two packages share a
    workspace file for file.
"""

from __future__ import annotations

import os
from pathlib import Path

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
