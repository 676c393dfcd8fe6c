"""Train/test splitting reproducing the reference's evaluation protocol
(counterpart of stutter_tpu/train/splits.py, NumPy only).

Ref: stratified 80/20 split with random_state=42 (pipeline1.py:476-477,
main.py:994-996) and StratifiedKFold(5, shuffle=True, random_state=42)
(main.py:892).  sklearn is used when available so fold assignments are
bit-identical to the reference's; a self-contained fallback provides the same
protocol (stratified, seeded) without the dependency -- the branch that runs
where sklearn is not installed.
"""

from __future__ import annotations

import numpy as np

try:
    from sklearn.model_selection import StratifiedKFold as _SKF
    from sklearn.model_selection import train_test_split as _tts

    HAVE_SKLEARN = True
except ImportError:  # pragma: no cover
    HAVE_SKLEARN = False


def stratified_train_test_split(
    y: np.ndarray, test_size: float = 0.2, seed: int = 42
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (train_idx, test_idx)."""
    idx = np.arange(len(y))
    if HAVE_SKLEARN:
        tr, te = _tts(idx, test_size=test_size, stratify=y, random_state=seed)
        return np.asarray(tr), np.asarray(te)
    rng = np.random.RandomState(seed)
    tr_parts, te_parts = [], []
    for c in np.unique(y):
        rows = idx[y == c]
        rng.shuffle(rows)
        n_te = int(round(len(rows) * test_size))
        te_parts.append(rows[:n_te])
        tr_parts.append(rows[n_te:])
    return np.concatenate(tr_parts), np.concatenate(te_parts)


def stratified_kfold(
    y: np.ndarray, n_splits: int = 5, seed: int = 42
) -> list[tuple[np.ndarray, np.ndarray]]:
    """List of (train_idx, test_idx), shuffled stratified K-fold."""
    idx = np.arange(len(y))
    if HAVE_SKLEARN:
        skf = _SKF(n_splits=n_splits, shuffle=True, random_state=seed)
        return [(np.asarray(tr), np.asarray(te)) for tr, te in skf.split(idx, y)]
    rng = np.random.RandomState(seed)
    fold_of = np.zeros(len(y), np.int32)
    for c in np.unique(y):
        rows = idx[y == c]
        rng.shuffle(rows)
        for i, r in enumerate(rows):
            fold_of[r] = i % n_splits
    return [(idx[fold_of != k], idx[fold_of == k]) for k in range(n_splits)]
