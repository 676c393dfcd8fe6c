"""The sequence heads' registry and artifact writer (the serving half of
stutter_tpu/train/seq_pipeline.py; training is not ported yet).

ARCHS maps each architecture name the JAX package trains to its feature
kind, its module class and its init widths.  The three transformer recipes
share one architecture (and so can run stacked); they differ only in how
the JAX package trains them.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from stutter_tpu_torch.models.cnn import CNN, init_cnn
from stutter_tpu_torch.models.cnn_bilstm import CNNBiLSTM, init_cnn_bilstm
from stutter_tpu_torch.models.transformer import Transformer, init_transformer


def _logmel(n_classes):
    return {"n_mels": 128, "n_classes": n_classes}


_TRANSFORMER = dict(kind="logmel", module=Transformer, init_fn=init_transformer,
                    init_kwargs=_logmel)

ARCHS = {
    "cnn": dict(kind="logmel", module=CNN, init_fn=init_cnn, init_kwargs=_logmel),
    "cnn_bilstm": dict(kind="mfcc_deltas", module=CNNBiLSTM, init_fn=init_cnn_bilstm,
                       init_kwargs=lambda n_classes: {"in_dim": 60, "n_classes": n_classes}),
    "transformer": _TRANSFORMER,
    "transformer_lr1e3": _TRANSFORMER,
    "transformer_mix4_lr1e3": _TRANSFORMER,
}


def persist_seq_head(
    out_dir: str, arch: str, params: dict, mean: np.ndarray, std: np.ndarray,
    classes: list[str],
) -> None:
    """Write the artifact trio SeqPredictor.load reads, as the JAX package
    writes it: params in the JAX layout (numpy) + normalization stats +
    metadata json."""
    from stutter_tpu_torch.persist import _flatten_params

    np.savez(os.path.join(out_dir, f"model_{arch}.npz"), **_flatten_params(params))
    np.savez(os.path.join(out_dir, f"model_{arch}_norm.npz"), mean=mean, std=std)
    Path(os.path.join(out_dir, f"model_{arch}.json")).write_text(
        json.dumps({"arch": arch, "classes": classes, "kind": ARCHS[arch]["kind"]})
    )
