"""Sequence-head training driver and registry (counterpart of
stutter_tpu/train/seq_pipeline.py): the CNN, CNN-BiLSTM and transformer
heads over the workspace corpus.

ARCHS maps each architecture name the JAX package trains to its feature
kind, its module class and its init widths.  The three transformer recipes
share one architecture (and so run stacked when served); they differ only
in their training recipe (`default_train_cfg`).  `cross_validate_seq`
trains the folds x seeds grid in chunks of `grid_chunk` entries,
`fit_seq_head` refits one head on all rows, `run_seq` trains one head on
the reference's 80/20 split, and `persist_seq_head` writes the artifacts
SeqPredictor and EnsemblePredictor (of either package) read.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from stutter_tpu_torch import evals
from stutter_tpu_torch.config import PipelineConfig
from stutter_tpu_torch.data import label_of, list_audio_files
from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.models.cnn import CNN, init_cnn
from stutter_tpu_torch.models.cnn_bilstm import CNNBiLSTM, init_cnn_bilstm
from stutter_tpu_torch.models.transformer import Transformer, init_transformer
from stutter_tpu_torch.train.seq_trainer import (
    SeqTrainConfig,
    balanced_row_weights,
    predict_sequence_model,
    prepare_sequence_dataset,
    standardize_sequences,
    train_sequence_model,
)
from stutter_tpu_torch.train.splits import stratified_train_test_split


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


def default_train_cfg(arch: str, epochs: int = 80) -> SeqTrainConfig:
    """The measured-best training recipe per arch (the JAX package's r2 aug
    sweep and r3 transformer sweep): mixup 0.2 on the log-mel heads, 0.4
    for transformer_mix4_lr1e3, none for the BiLSTM; lr 1e-3 for the two
    _lr1e3 recipes, 2e-3 otherwise; batch 64."""
    mixup = 0.2 if ARCHS[arch]["kind"] == "logmel" else 0.0
    if arch == "transformer_mix4_lr1e3":
        mixup = 0.4
    lr = 1e-3 if arch in ("transformer_lr1e3", "transformer_mix4_lr1e3") else 2e-3
    return SeqTrainConfig(epochs=epochs, batch_size=64, mixup_alpha=mixup, learning_rate=lr)


def load_corpus_clips(
    root: str, cfg: PipelineConfig, with_stems: bool = False, with_files: bool = False, *,
    device: torch.device | str = "cuda",
):
    """Denoised corpus clips (clear_audio by stem) + labels, through the
    port's WAV loader (its resampler on `device`).  with_stems=True also
    returns the corpus file stems of the kept clips, in order; with_files=True
    (implies with_stems) also returns the ORIGINAL corpus audio paths, so
    raw (pre-denoise) views of the same rows can be decoded."""
    from stutter_tpu_torch.io.native import load_wav_batch
    from stutter_tpu_torch.ops.frontend import DEFAULT_BUCKETS

    files = list_audio_files(os.path.join(root, cfg.data.data_dir), cfg.data.audio_exts)
    paths, labels, stems, srcs = [], [], [], []
    for f in files:
        w = os.path.join(root, cfg.data.clear_dir, Path(f).stem + ".wav")
        if os.path.exists(w):
            paths.append(w)
            labels.append(label_of(f))
            stems.append(Path(f).stem)
            srcs.append(f)
    audio, lens = load_wav_batch(paths, DEFAULT_BUCKETS[-1], cfg.features.frontend.sample_rate,
                                 device=device)
    clips = [audio[i, : lens[i]] for i in range(len(paths)) if lens[i] > 0]
    labels = [l for l, n in zip(labels, lens) if n > 0]
    stems = [s for s, n in zip(stems, lens) if n > 0]
    srcs = [f for f, n in zip(srcs, lens) if n > 0]
    if with_files:
        return clips, labels, stems, srcs
    if with_stems:
        return clips, labels, stems
    return clips, labels


def cross_validate_seq(
    arch: str,
    clips: list[np.ndarray],
    y: np.ndarray,
    folds: list[tuple[np.ndarray, np.ndarray]],
    n_classes: int,
    train_cfg: SeqTrainConfig = SeqTrainConfig(epochs=80, batch_size=64),
    n_seeds: int = 1,
    grid_chunk: int = 5,
    tta_crops: tuple = (),
    view_probas: list | None = None,
    soft_targets: np.ndarray | None = None,
    *,
    device: torch.device | str = "cuda",
    mesh=None,
) -> tuple[np.ndarray, np.ndarray]:
    """K-fold CV for a sequence head; returns (y_pred, y_proba) in row order.

    The folds x seeds grid (G = K * n_seeds entries) trains in equal chunks
    of at most `grid_chunk` entries a device, the chunk split over the mesh
    (train_seq_grid_sharded; every visible GPU for an unindexed `cuda`, as
    parallel.mesh.resolve_mesh says), sharing the dataset, which is
    featurized once on the mesh's first device; each entry carries its
    fold's sampling weights and standardization stats (train rows only) and
    the seed train_cfg.seed + s.  n_seeds > 1 soft-votes each fold's
    members.  A chunk's activations grow with its entries x batch x frames
    x features, so `grid_chunk` bounds the memory a grid takes on a device;
    an entry's result depends neither on it nor on the mesh.
    tta_crops: for each crop c (frames) also predict a start-cropped view
    (features shifted left by c, c fewer valid frames) and an end-cropped
    view (the last c valid frames masked) and average them with the
    identity view.  view_probas: a list, extended with each view's
    fold-voted out-of-fold probabilities ([N, C] per view, identity first).
    soft_targets [N, C]: train every entry on these probability targets
    instead of the smoothed one-hot labels; `y` keeps the folds and the
    evaluation."""
    from stutter_tpu_torch.parallel.mesh import resolve_mesh
    from stutter_tpu_torch.train.seq_trainer import predict_seq_grid, train_seq_grid_sharded

    mesh = resolve_mesh(mesh, device)
    dev = mesh[0]
    spec = ARCHS[arch]
    X, nv = prepare_sequence_dataset(clips, kind=spec["kind"], device=dev)
    N, _, D = X.shape
    K = len(folds)
    G = K * n_seeds

    w = np.zeros((G, N), np.float32)
    mean_g = np.zeros((G, D), np.float32)
    std_g = np.ones((G, D), np.float32)
    seeds = np.zeros(G, np.int64)
    for k, (tr, _) in enumerate(folds):
        _, mean, std = standardize_sequences(X[tr], nv[tr])
        # cfg.class_balanced: inverse-frequency sampling weights instead of
        # uniform fold membership (the sampler normalizes either way)
        row_w = balanced_row_weights(y[tr], n_classes) if train_cfg.class_balanced else 1.0
        for s in range(n_seeds):
            g = k * n_seeds + s
            w[g, tr] = row_w
            mean_g[g], std_g[g] = mean, std
            seeds[g] = train_cfg.seed + s
    n_train = max(len(tr) for tr, _ in folds)

    chunk = max(1, min(grid_chunk * len(mesh), G))
    while G % chunk:
        chunk -= 1

    views = [(X, nv)]
    for c in tta_crops:
        X_start = np.concatenate([X[:, c:], np.zeros((N, c, D), X.dtype)], axis=1)
        views.append((X_start, np.maximum(nv - c, 1)))  # start-cropped
        views.append((X, np.maximum(nv - c, 1)))  # end-cropped

    probs = np.zeros((len(views), G, N, n_classes), np.float32)
    for g0 in range(0, G, chunk):
        g1 = g0 + chunk
        grids = train_seq_grid_sharded(
            mesh, X, nv, y, w[g0:g1], mean_g[g0:g1], std_g[g0:g1], seeds[g0:g1],
            module=spec["module"], init_fn=spec["init_fn"],
            init_items=tuple(sorted(spec["init_kwargs"](n_classes).items())),
            n_classes=n_classes, cfg=train_cfg, n_train=n_train, y_soft=soft_targets,
        )
        for s, grid in grids:
            g = slice(g0 + s.start, g0 + s.stop)
            for v, (Xv, nvv) in enumerate(views):
                probs[v, g] = predict_seq_grid(grid, Xv, nvv, mean_g[g], std_g[g], batch=64)
        del grids

    # each fold's held-out rows, soft-voted over its seeds, per view; the
    # returned proba averages the views (== identity when tta_crops is empty)
    probs = probs.reshape(len(views), K, n_seeds, N, -1).mean(axis=2)
    per_view = np.zeros((len(views), N, n_classes), np.float32)
    for k, (_, te) in enumerate(folds):
        per_view[:, te] = probs[:, k][:, te]
    if view_probas is not None:
        view_probas.extend(per_view)
    y_proba = per_view.mean(axis=0)
    return y_proba.argmax(-1), y_proba


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


def fit_seq_head(
    arch: str,
    clips: list[np.ndarray],
    y: np.ndarray,
    n_classes: int,
    train_cfg: SeqTrainConfig = SeqTrainConfig(epochs=80, batch_size=64),
    *,
    device: torch.device | str = "cuda",
) -> tuple[dict, np.ndarray, np.ndarray]:
    """Train one sequence head on ALL given clips (the production refit);
    returns (params, mean, std) ready for persist_seq_head."""
    dev = resolve_device(device)
    spec = ARCHS[arch]
    X, nv = prepare_sequence_dataset(clips, kind=spec["kind"], device=dev)
    Xs, mean, std = standardize_sequences(X, nv)
    params = train_sequence_model(spec["module"], spec["init_fn"], Xs, nv, y, n_classes,
                                  train_cfg, spec["init_kwargs"](n_classes), device=dev)
    return params, mean, std


def run_seq(
    root: str = ".",
    arch: str = "cnn_bilstm",
    cfg: PipelineConfig = PipelineConfig(),
    train_cfg: SeqTrainConfig = SeqTrainConfig(epochs=80, batch_size=64),
    ckpt: bool = False,
    labels_taxonomy: str = "folder",
    *,
    device: torch.device | str = "cuda",
) -> dict:
    """Train one sequence head on the workspace corpus's stratified 80/20
    split; returns metrics + params, and writes the head's artifacts and
    confusion_<arch>.csv.  ckpt=True checkpoints the training state under
    output_results/ckpt_<arch> and resumes from it.

    The standardization stats come from ALL clips, the test split's too,
    before the split -- as the JAX package does: the test rows' feature
    statistics reach the training inputs (no labels do), and the persisted
    stats are the ones a servable head needs.  labels_taxonomy='5class'
    maps corpus folders into the 5-class taxonomy (a 5-output head)."""
    from stutter_tpu_torch.data import encode_labels

    dev = resolve_device(device)
    spec = ARCHS[arch]
    out_dir = os.path.join(root, cfg.data.output_dir)
    os.makedirs(out_dir, exist_ok=True)

    clips, labels = load_corpus_clips(root, cfg, device=dev)
    labels, le = encode_labels(labels, labels_taxonomy)
    y = le.transform(labels)
    n_classes = len(le.classes_)
    tr, te = stratified_train_test_split(y, cfg.train.test_size, cfg.train.seed)

    t0 = time.time()
    X, nv = prepare_sequence_dataset(clips, kind=spec["kind"], device=dev)
    Xs, mean, std = standardize_sequences(X, nv)
    params = train_sequence_model(
        spec["module"], spec["init_fn"], Xs[tr], nv[tr], y[tr], n_classes, train_cfg,
        spec["init_kwargs"](n_classes),
        ckpt_dir=os.path.join(out_dir, f"ckpt_{arch}") if ckpt else None, device=dev,
    )
    model = spec["module"].from_jax_params(params, device=dev)
    proba = predict_sequence_model(model, Xs[te], nv[te], device=dev)
    pred = proba.argmax(-1)
    acc = evals.accuracy(y[te], pred) * 100
    loss = evals.log_loss(y[te], proba)
    elapsed = time.time() - t0

    persist_seq_head(out_dir, arch, params, mean, std, le.classes_)
    cm = evals.confusion_matrix(y[te], pred, n_classes)
    evals.write_confusion_csv(os.path.join(out_dir, f"confusion_{arch}.csv"), cm, le.classes_)
    return {"arch": arch, "accuracy": acc, "test_loss": loss, "elapsed_s": elapsed,
            "classes": le.classes_, "params": params}
