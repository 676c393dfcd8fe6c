"""End-to-end entry points (counterpart of stutter_tpu/pipeline.py):

  * preprocess():        denoise every corpus clip into clear_audio/ and
                         write the per-file QC report per_file_analysis.csv
                         (ref pipeline1.py:371-424, main.py:842-867)
  * extract_corpus():    the feature cache, both variants
                         (ref pipeline1.py:429-456, main.py:665-672)
  * run_before_after():  engine A -- one stratified 80/20 split, raw vs
                         clean features (ref pipeline1.py:462-637)
  * run_cv():            engine B -- the 5-fold CV table, the persisted
                         production MLP and its permutation importance
                         (ref main.py:872-1006); with include_seq, the
                         sequence heads' CV grids, their nested weighted
                         vote and the servable quint (refit heads and
                         ensemble.json)

Each runs on an explicit device: the gate and spectromel kernels and the
MLP and sequence-head grids on `cuda`, their plain versions on `cpu`.
They write what the JAX package writes -- the same clear_audio/ files, the
same cache_features/ names (`cache.FeatureCache`, with the `_d286`
namespace of the 286-dim variant), and the same CSV, HTML, .npz and .json
artifacts under the same names, headers and row names ("MLP-TPU" for the
seed-ensembled MLP) -- so either package reads the other's workspace.  sklearn's model zoo and the
reference's pickles are written where sklearn and joblib are installed.

Unlike the JAX package, a device or kernel error is never caught: an
undecodable file degrades its own row, a malformed clip is left raw by the
denoiser, and a host (sklearn) model that fails is logged and left out of
the tables, but a kernel or a training grid failing raises through every
entry point.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

import numpy as np
import torch

from stutter_tpu_torch import evals, persist, report
from stutter_tpu_torch.cache import FeatureCache
from stutter_tpu_torch.config import DenoiseConfig, PipelineConfig
from stutter_tpu_torch.data import encode_labels, label_of, list_audio_files
from stutter_tpu_torch.denoise import denoise_clips
from stutter_tpu_torch.evals import write_csv
from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.io.decode import read_audio, to_rate
from stutter_tpu_torch.io.wav import load_mono, write_wav
from stutter_tpu_torch.models.mlp import SeedMLP
from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler
from stutter_tpu_torch.ops.frontend import DEFAULT_BUCKETS, batch_extractor_for, run_bucketed
from stutter_tpu_torch.train.splits import stratified_kfold, stratified_train_test_split
from stutter_tpu_torch.train.trainer import MLPTrainConfig, cross_validate_mlp, fit_mlp
from stutter_tpu_torch.utils.profiling import StageTimer

log = logging.getLogger("stutter_tpu_torch.pipeline")

QC_KEYS = ("snr_db", "spectral_flatness", "hf_energy_ratio")


def setup_logging(output_dir: str) -> None:
    """File logging to output_dir/pipeline.log, like the reference (main.py:573-577)."""
    os.makedirs(output_dir, exist_ok=True)
    logging.basicConfig(
        filename=os.path.join(output_dir, "pipeline.log"),
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
    )


def _load_clip(path: str, sr: int, decoder=None,
               device: torch.device | str = "cuda") -> np.ndarray | None:
    """The clip at `sr`, or None when no decoder reads the file
    (ref pipeline1.py:100-106); resampling runs on `device`."""
    device = resolve_device(device)
    try:
        y, file_sr = read_audio(path, sr, decoder)
    except Exception as e:  # noqa: BLE001 - an undecodable file degrades its row
        log.error("load_audio fail %s: %s", path, e)
        return None
    return to_rate(y, file_sr, sr, device)


def _denoise_with_fallback(
    clips: list, cfg: DenoiseConfig, device: torch.device | str = "cuda"
) -> list[np.ndarray | None]:
    """Denoise a batch of clips; a clip that is not 1-D float audio is left
    out and returned as None (the caller keeps it raw, ref main.py:662-663).
    Errors of the denoiser itself -- a kernel that fails to build or
    launch -- propagate."""
    device = resolve_device(device)
    out: list[np.ndarray | None] = [None] * len(clips)
    good: list[tuple[int, np.ndarray]] = []
    for i, y in enumerate(clips):
        try:
            arr = np.asarray(y, np.float32)
            if arr.ndim != 1:
                raise ValueError(f"clip of shape {arr.shape} is not 1-D")
        except (TypeError, ValueError) as e:
            log.error("denoise skipped for clip %d (%s); falling back to raw", i, e)
            continue
        good.append((i, arr))
    if good:
        cleaned = denoise_clips([y for _, y in good], cfg, device=device)
        for (i, _), y in zip(good, cleaned):
            out[i] = y
    return out


def preprocess(
    root: str = ".", cfg: PipelineConfig = PipelineConfig(), decoder=None, *,
    device: torch.device | str,
) -> list[dict]:
    """Clean every corpus clip (cached in clear_audio/) and compute the QC
    metrics before and after -> per_file_analysis.csv rows, returned."""
    from stutter_tpu_torch.ops.qc import qc_metrics_batch

    dev = resolve_device(device)
    data = cfg.data
    sr = cfg.features.frontend.sample_rate
    clear_dir = os.path.join(root, data.clear_dir)
    out_dir = os.path.join(root, data.output_dir)
    os.makedirs(clear_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)

    timer = StageTimer()
    files = list_audio_files(os.path.join(root, data.data_dir), data.audio_exts)
    pending: list[tuple[str, str, np.ndarray]] = []
    with timer.stage("decode_raw"):
        for f in files:
            y = _load_clip(f, sr, decoder, dev)
            if y is not None:
                pending.append((f, label_of(f), y))
    skipped = len(files) - len(pending)

    def qc_of(clips: list[np.ndarray]) -> dict[str, np.ndarray]:
        def qc_stack(a, n):
            m = qc_metrics_batch(a, n, sr)
            return torch.stack([m[k] for k in QC_KEYS], dim=-1)

        vals = run_bucketed(clips, qc_stack, len(QC_KEYS), device=dev)
        return {k: vals[:, j] for j, k in enumerate(QC_KEYS)}

    raw_clips = [y for _, _, y in pending]
    # clean, reusing clear_audio/ entries (ref pipeline1.py:131-135)
    cleaned_clips: list[np.ndarray | None] = []
    to_denoise_idx = []
    for i, (f, _, _) in enumerate(pending):
        cached = os.path.join(clear_dir, Path(f).stem + ".wav")
        if os.path.exists(cached):
            cleaned_clips.append(_load_clip(cached, sr, device=dev))
        else:
            cleaned_clips.append(None)
            to_denoise_idx.append(i)
    if to_denoise_idx:
        with timer.stage("denoise"):
            denoised = _denoise_with_fallback([raw_clips[i] for i in to_denoise_idx],
                                              cfg.denoise, dev)
        for i, y in zip(to_denoise_idx, denoised):
            if y is None:
                cleaned_clips[i] = raw_clips[i]  # per-file degrade (ref main.py:662-663)
                continue
            out_path = os.path.join(clear_dir, Path(pending[i][0]).stem + ".wav")
            write_wav(out_path, y, sr)
            cleaned_clips[i], _ = load_mono(out_path, sr=sr)  # the 16-bit round trip

    with timer.stage("qc_before"):
        qc_before = qc_of(raw_clips)
    with timer.stage("qc_after"):
        qc_after = qc_of([c if c is not None else r for c, r in zip(cleaned_clips, raw_clips)])

    rows = []
    for i, (f, label, y) in enumerate(pending):
        rows.append({
            "file": os.path.basename(f),
            "label": label,
            "duration_sec": len(y) / sr,
            "snr_before_db": qc_before["snr_db"][i],
            "snr_after_db": qc_after["snr_db"][i],
            "spectral_flatness_before": qc_before["spectral_flatness"][i],
            "spectral_flatness_after": qc_after["spectral_flatness"][i],
            "hf_energy_ratio_before": qc_before["hf_energy_ratio"][i],
            "hf_energy_ratio_after": qc_after["hf_energy_ratio"][i],
            "transcript": "",
        })
    log.info("preprocessed %d files, skipped %d", len(rows), skipped)
    timer.log_report()
    write_csv(
        os.path.join(out_dir, "per_file_analysis.csv"),
        list(rows[0].keys()) if rows else ["file"],
        [list(r.values()) for r in rows],
    )
    return rows


def extract_corpus(
    root: str = ".",
    cfg: PipelineConfig = PipelineConfig(),
    suffix: str = "clean",
    decoder=None,
    *,
    device: torch.device | str,
) -> tuple[np.ndarray, list[str], list[str], np.ndarray]:
    """Feature extraction over the corpus with cache reuse, for the variant
    of cfg.features (each variant has its own cache namespace).

    suffix='clean' reads clear_audio/<stem>.wav; suffix='raw' decodes the
    original files, with `decoder` (path, sr -> float32 PCM) for formats the
    WAV readers do not take.  Returns (X [n, D], labels, files, ok [n]):
    rows whose audio no decoder reads are zero with ok=False."""
    from stutter_tpu_torch.io.native import BatchPrefetcher

    dev = resolve_device(device)
    data = cfg.data
    sr = cfg.features.frontend.sample_rate
    dim = cfg.features.total_feature_len
    files = list_audio_files(os.path.join(root, data.data_dir), data.audio_exts)
    cache = FeatureCache(os.path.join(root, data.cache_dir), dim)

    labels = [label_of(f) for f in files]
    X = np.zeros((len(files), dim), np.float32)
    ok = np.zeros(len(files), bool)
    miss_rows: list[int] = []
    miss_paths: list[str] = []
    for i, f in enumerate(files):
        cached = cache.load(f, suffix)
        if cached is not None and cached.shape == (dim,):
            X[i] = cached
            ok[i] = True
            continue
        miss_rows.append(i)
        miss_paths.append(os.path.join(root, data.clear_dir, Path(f).stem + ".wav")
                          if suffix == "clean" else f)
    if miss_rows:
        timer = StageTimer()
        fn = batch_extractor_for(cfg.features)
        prefetch = BatchPrefetcher(miss_paths, DEFAULT_BUCKETS[-1], batch_size=256, sr=sr,
                                   decoder=decoder, device=dev)
        pos = 0
        for audio, lens, chunk in prefetch:
            rows = miss_rows[pos : pos + len(chunk)]
            pos += len(chunk)
            keep = [(i, audio[j, : lens[j]]) for j, i in enumerate(rows) if lens[j] > 0]
            if not keep:
                continue
            with timer.stage("extract"):
                feats = run_bucketed([y for _, y in keep], fn, dim, device=dev)
            with timer.stage("cache_store"):
                for (i, _), v in zip(keep, feats):
                    X[i] = v
                    ok[i] = True
                    cache.store(files[i], suffix, v)
        timer.log_report()
    n_failed = int((~ok).sum())
    if n_failed:
        log.warning("extract_corpus(%s): %d/%d rows failed decode and are zero/ok=False",
                    suffix, n_failed, len(files))
    return X, labels, files, ok


def _host_zoo(variant: str, seed: int) -> dict:
    """The reference's sklearn models (host_baselines), or {} where sklearn
    is not installed."""
    from stutter_tpu_torch.models.host_baselines import reference_model_zoo

    try:
        return reference_model_zoo(variant, seed)
    except ImportError:
        log.warning("sklearn unavailable; host baselines skipped")
        return {}


class _TpuMLPAdapter:
    """sklearn-like adapter over the seed-ensembled MLP on one device."""

    def __init__(self, cfg: MLPTrainConfig, device: torch.device | str = "cuda"):
        self.cfg, self.device = cfg, resolve_device(device)
        self.fitted: SeedMLP | None = None

    def fit(self, X, y):
        self.fitted = fit_mlp(np.asarray(X, np.float32), np.asarray(y), self.cfg,
                              device=self.device)
        return self

    def predict_proba(self, X) -> np.ndarray:
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
            return self.fitted(x).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        return self.predict_proba(X).argmax(axis=-1)


def _evaluate_models(models: dict, X_tr, y_tr, X_te, y_te, set_name, out_dir, class_names,
                     timer: StageTimer):
    """Fit, predict and write the metrics of each model on one dataset --
    engine A's inner loop (ref: pipeline1.py:508-531): confusion_<set>_<model>
    and class_report_<set>_<model> CSVs, confusion_<set>.html, auc_<set>.csv,
    roc_<set>.csv and roc_<set>.html.  Each model's fit and predictions are
    timed as the stage <set>_<model> of `timer`."""
    metrics_rows, probs, preds, cm_svgs = [], {}, {}, []
    for name, model in models.items():
        try:
            with timer.stage(f"{set_name}_{name}"):
                model.fit(X_tr, y_tr)
                p = model.predict(X_te)
                pr = model.predict_proba(X_te)
        except Exception as e:  # noqa: BLE001 - a host model degrades its own row
            if isinstance(model, _TpuMLPAdapter):
                raise
            log.error("training error %s on %s: %s", name, set_name, e)
            continue
        acc = evals.accuracy(y_te, p) * 100.0
        loss = evals.log_loss(y_te, pr)
        metrics_rows.append({"dataset": set_name, "model": name, "accuracy": acc, "test_loss": loss})
        probs[name], preds[name] = pr, p
        log.info("%s/%s acc=%.2f%% loss=%.4f (%.1fs)", set_name, name, acc, loss,
                 timer.totals[f"{set_name}_{name}"])

        cm = evals.confusion_matrix(y_te, p, len(class_names))
        evals.write_confusion_csv(
            os.path.join(out_dir, f"confusion_{set_name}_{name}.csv"), cm, class_names)
        cm_svgs.append((name, cm))
        evals.write_classification_report_csv(
            os.path.join(out_dir, f"class_report_{set_name}_{name}.csv"),
            evals.classification_report_dict(y_te, p, class_names))
    if cm_svgs:  # per-model heatmaps (ref renders them with Plotly, pipeline1.py:570-600)
        report.write_html(
            os.path.join(out_dir, f"confusion_{set_name}.html"),
            f"Confusion Matrices ({set_name})",
            [report.confusion_svg(cm, class_names, f"{name} ({set_name})") for name, cm in cm_svgs],
        )

    # per-class ROC/AUC across models (ref plot_roc; roc_{before,after}.html,
    # pipeline1.py:553, 563)
    auc_rows, roc_rows, curves = [], [], []
    for name, pr in probs.items():
        for c, cls in enumerate(class_names):
            y_bin = np.asarray(y_te) == c
            fpr, tpr, thr = evals.roc_curve(y_bin, pr[:, c])
            auc = evals.auc_score(y_bin, pr[:, c])
            auc_rows.append({"model": name, "class": cls, "auc": auc})
            curves.append({"label": f"{name} - {cls}", "fpr": fpr, "tpr": tpr, "auc": auc})
            roc_rows += [{"model": name, "class": cls, "fpr": f, "tpr": t, "threshold": th}
                         for f, t, th in zip(fpr, tpr, thr)]
    evals.write_auc_csv(os.path.join(out_dir, f"auc_{set_name}.csv"), auc_rows)
    evals.write_roc_points_csv(os.path.join(out_dir, f"roc_{set_name}.csv"), roc_rows)
    report.write_html(
        os.path.join(out_dir, f"roc_{set_name}.html"),
        f"Multi-Class ROC ({set_name})",
        [report.roc_svg(curves, f"Multi-Class ROC ({set_name})")],
    )
    return metrics_rows, probs, preds


def run_before_after(
    root: str = ".", cfg: PipelineConfig = PipelineConfig(), *,
    device: torch.device | str = "cuda",
) -> dict:
    """Engine A: raw-vs-clean comparison on one stratified 80/20 split
    (ref: pipeline1.py:462-637), MLP-TPU beside the pipeline1 sklearn zoo.

    MLP-TPU has as many outputs as the corpus has classes; the JAX package
    trains it with 3 whatever the class count.  `stage_s`: wall seconds of
    the features and of each <set>_<model> fit with its predictions."""
    dev = resolve_device(device)
    out_dir = os.path.join(root, cfg.data.output_dir)
    os.makedirs(out_dir, exist_ok=True)

    timer = StageTimer()
    with timer.stage("features"):
        X_raw, labels, _, ok_r = extract_corpus(root, cfg, "raw", device=dev)
        X_clean, _, _, ok_c = extract_corpus(root, cfg, "clean", device=dev)
    keep = ok_r & ok_c
    if not keep.all():
        log.warning("dropping %d undecodable rows from engine A", int((~keep).sum()))
        X_raw, X_clean = X_raw[keep], X_clean[keep]
        labels = [l for l, k in zip(labels, keep) if k]
    if not labels:
        raise RuntimeError("no decodable corpus rows; run preprocess first")
    le = LabelEncoder.fit(labels)
    y = le.transform(labels)
    class_names = le.classes_
    mlp_cfg = MLPTrainConfig(n_classes=len(class_names))

    Xb = StandardScaler.fit(X_raw).transform(X_raw)
    Xa = StandardScaler.fit(X_clean).transform(X_clean)
    tr, te = stratified_train_test_split(y, cfg.train.test_size, cfg.train.seed)
    write_csv(os.path.join(out_dir, "train_test_sizes.csv"),
              ["dataset", "train_size", "test_size"],
              [["before", len(tr), len(te)], ["after", len(tr), len(te)]])

    all_metrics, results = [], {}
    for set_name, X in (("before", Xb), ("after", Xa)):
        models = {"MLP-TPU": _TpuMLPAdapter(mlp_cfg, dev),
                  **_host_zoo("pipeline1", cfg.train.seed)}
        m, probs, preds = _evaluate_models(models, X[tr], y[tr], X[te], y[te], set_name,
                                           out_dir, class_names, timer)
        all_metrics += m
        results[set_name] = {"models": models, "probs": probs, "preds": preds}
    evals.write_metrics_summary_csv(os.path.join(out_dir, "metrics_summary.csv"), all_metrics)

    # accuracy / log-loss bars (ref renders these with Plotly, pipeline1.py:533-542)
    bar_labels = [f'{r["dataset"]}/{r["model"]}' for r in all_metrics]
    report.write_html(
        os.path.join(out_dir, "metrics_summary.html"),
        "Before/After Cleaning — Model Metrics",
        [report.bar_svg(bar_labels, [r["accuracy"] for r in all_metrics], "Accuracy (%)"),
         report.bar_svg(bar_labels, [r["test_loss"] for r in all_metrics], "Log-loss", unit="")],
    )

    # RF feature importances on 'after' (ref: pipeline1.py:605-618)
    rf = results["after"]["models"].get("RandomForest")
    if rf is not None and hasattr(rf, "feature_importances_"):
        names = cfg.features.feature_names()
        imp = rf.feature_importances_
        write_csv(os.path.join(out_dir, "feature_importances_after_rf.csv"),
                  ["feature", "importance"],
                  [[names[i], float(imp[i])] for i in np.argsort(-imp)])
    timer.log_report()
    return {"metrics": all_metrics, "y_test": y[te], "results": results, "classes": class_names,
            "stage_s": dict(timer.totals)}


def _cv_row(name: str, y_true: np.ndarray, y_pred: np.ndarray, folds, n_classes: int) -> dict:
    """Per-fold macro metrics averaged across folds -- the reference's
    protocol exactly (ref: main.py:918-944), not pooled out-of-fold."""
    accs, ps, rs, fs = [], [], [], []
    for _, te in folds:
        accs.append(evals.accuracy(y_true[te], y_pred[te]))
        p, r, f, _ = evals.precision_recall_fscore(y_true[te], y_pred[te], n_classes, "macro")
        ps.append(p), rs.append(r), fs.append(f)
    return {
        "Model": name,
        "Accuracy (%)": float(np.mean(accs)) * 100,
        "Precision (%)": float(np.mean(ps)) * 100,
        "Recall (%)": float(np.mean(rs)) * 100,
        "F1-Score (%)": float(np.mean(fs)) * 100,
    }


def _run_seq_members(root, cfg: PipelineConfig, le: LabelEncoder, labels_taxonomy: str,
                     out_dir: str, timer: StageTimer, dev: torch.device, *, seq_seeds: int,
                     seq_epochs: int, ensemble_mlp: str, seq_archs: tuple, seq_tta_crops: tuple,
                     seq_raw_archs: tuple, seq_class_balanced: bool) -> list[dict]:
    """run_cv's sequence heads (the JAX package's pipeline.py:571-774) ->
    their table rows; writes oof_probas.npz, ensemble_weights.json, the
    refit members' artifacts, ensemble.json and, with raw probe members,
    ensemble_probe.json."""
    import dataclasses

    from stutter_tpu_torch.data import map_labels_to_5class
    from stutter_tpu_torch.ops.frontend import extract_features_numpy
    from stutter_tpu_torch.train.ensemble import nested_weighted_vote
    from stutter_tpu_torch.train.seq_pipeline import (
        cross_validate_seq, default_train_cfg, fit_seq_head, load_corpus_clips,
        persist_seq_head)

    class_names = le.classes_
    n_classes = len(class_names)
    with timer.stage("seq_clips"):
        clips, seq_labels, seq_stems, seq_files = load_corpus_clips(root, cfg, with_files=True,
                                                                     device=dev)
    if labels_taxonomy == "5class":
        seq_labels = map_labels_to_5class(seq_labels)
    y_seq = le.transform(seq_labels)
    seq_folds = stratified_kfold(y_seq, cfg.train.n_folds, cfg.train.seed)
    rows: list[dict] = []
    seq_probas: dict[str, np.ndarray] = {}
    seq_probas_tta: dict[str, np.ndarray] = {}

    def row(name, y_pred):
        rows.append(_cv_row(name, y_seq, y_pred, seq_folds, n_classes))
        return rows[-1]["Accuracy (%)"]

    def arch_cfg(arch):
        tc = default_train_cfg(arch, seq_epochs)
        return dataclasses.replace(tc, class_balanced=True) if seq_class_balanced else tc

    for arch in seq_archs:
        vp: list | None = [] if seq_tta_crops else None
        with timer.stage(f"seq_cv_{arch}"):
            pred_s, proba_s = cross_validate_seq(
                arch, clips, y_seq, seq_folds, n_classes, arch_cfg(arch), n_seeds=seq_seeds,
                tta_crops=seq_tta_crops, view_probas=vp, device=dev)
        if seq_tta_crops:
            # the identity view stays the production protocol; the
            # TTA-averaged probabilities get their own comparison row
            seq_probas[arch], seq_probas_tta[arch] = vp[0], proba_s
            pred_s = vp[0].argmax(-1)
            row(f"{arch.upper()}-TPU+TTA", proba_s.argmax(-1))
        else:
            seq_probas[arch] = proba_s
        log.info("%s CV done in %.1fs: acc=%.1f%%", arch, timer.totals[f"seq_cv_{arch}"],
                 row(f"{arch.upper()}-TPU", pred_s))

    if seq_raw_archs:
        # raw-view diversity members: the SAME rows and folds, decoded
        # before the gate (every default member sees gated audio); a file
        # no decoder reads keeps its denoised clip, so the rows stay aligned
        raw_clips = []
        for f, c in zip(seq_files, clips):
            y = _load_clip(f, cfg.features.frontend.sample_rate, device=dev)
            if y is None:
                log.warning("raw decode failed for %s; using the denoised clip", f)
            raw_clips.append(c if y is None else y)
        for arch in seq_raw_archs:
            with timer.stage(f"seq_cv_{arch}_raw"):
                _, proba_r = cross_validate_seq(arch, raw_clips, y_seq, seq_folds, n_classes,
                                                arch_cfg(arch), n_seeds=seq_seeds, device=dev)
            seq_probas[f"{arch}_raw"] = proba_r
            log.info("%s(raw) CV done in %.1fs: acc=%.1f%%", arch,
                     timer.totals[f"seq_cv_{arch}_raw"],
                     row(f"{arch.upper()}-RAW-TPU", proba_r.argmax(-1)))

    # The optional MLP member gets its own name, scaler and refit ("mlp_clean"
    # on the seq clips' features, or "mlp_both"): serving must load the
    # member the vote's weights were searched on, not engine B's MLP.
    mlp_name, X_seq, scaler_seq, Xs_seq = "mlp_clean", None, None, None
    mlp_cfg = MLPTrainConfig(n_classes=n_classes)
    with timer.stage("seq_vote"):
        if ensemble_mlp == "both":
            # cached per-file features (raw + clean) joined by stem
            X_raw_all, _, files_all, okr_all = extract_corpus(root, cfg, "raw", device=dev)
            X_clean_all, _, _, okc_all = extract_corpus(root, cfg, "clean", device=dev)
            stem_row = {Path(f).stem: i for i, f in enumerate(files_all)}
            at = [stem_row.get(s, -1) for s in seq_stems]
            bad = sum(1 for r in at if r < 0 or not (okr_all[r] and okc_all[r]))
            if not bad:
                X_seq = np.concatenate([X_raw_all[at], X_clean_all[at]], axis=1)
                mlp_name = "mlp_both"
            else:
                log.warning("raw+clean features unavailable for %d seq rows; ensemble "
                            "MLP member falls back to clean-only", bad)
        if ensemble_mlp != "none":
            if X_seq is None:
                X_seq = extract_features_numpy(clips, cfg.features, device=dev)
            scaler_seq = StandardScaler.fit(X_seq)
            Xs_seq = scaler_seq.transform(X_seq).astype(np.float32)
            _, seq_probas[mlp_name] = cross_validate_mlp(Xs_seq, y_seq, seq_folds, mlp_cfg,
                                                         device=dev)
        # the members' out-of-fold probabilities: vote experiments (weight
        # grids, stackers) then run offline without retraining any grid
        np.savez(
            os.path.join(out_dir, "oof_probas.npz"),
            y=y_seq,
            fold_of=np.concatenate([np.full(len(te), k, np.int32)
                                    for k, (_, te) in enumerate(seq_folds)])[
                np.argsort(np.concatenate([te for _, te in seq_folds]))],
            **{f"proba_{n}": p for n, p in seq_probas.items()},
        )
        pred_v, _, vote_weights = nested_weighted_vote(seq_probas, y_seq, seq_folds)
        acc_v = row("Weighted-Vote-TPU", pred_v)
        if seq_tta_crops:
            if ensemble_mlp != "none":
                seq_probas_tta[mlp_name] = seq_probas[mlp_name]
            pred_vt, _, _ = nested_weighted_vote(seq_probas_tta, y_seq, seq_folds)
            row("Weighted-Vote-TPU+TTA", pred_vt)
        with open(os.path.join(out_dir, "ensemble_weights.json"), "w") as f:
            json.dump(vote_weights, f, indent=1)
    log.info("weighted vote done in %.1fs: acc=%.1f%%", timer.totals["seq_vote"], acc_v)

    # the headline model made servable: each member refit on ALL rows and
    # persisted, and the fold-averaged vote weights for EnsemblePredictor
    for arch in seq_archs:
        with timer.stage(f"seq_fit_{arch}"):
            params_a, mean_a, std_a = fit_seq_head(arch, clips, y_seq, n_classes, arch_cfg(arch),
                                                   device=dev)
            persist_seq_head(out_dir, arch, params_a, mean_a, std_a, class_names)
    if ensemble_mlp != "none":
        with timer.stage("seq_fit_mlp"):
            suffix = mlp_name.removeprefix("mlp_")
            persist.save_mlp(os.path.join(out_dir, f"model_mlp_{suffix}_tpu"),
                             fit_mlp(Xs_seq, y_seq, mlp_cfg, device=dev))
            persist.save_scaler(os.path.join(out_dir, f"scaler_{suffix}.npz"), scaler_seq)
    avg_w = {name: float(np.mean([w[name] for w in vote_weights])) for name in vote_weights[0]}
    total_w = sum(avg_w.values()) or 1.0
    avg_w = {k: v / total_w for k, v in avg_w.items()}
    if seq_raw_archs:
        # raw probe members have no persisted refit, so a vote naming them
        # is not servable: the searched weights go to ensemble_probe.json,
        # and ensemble.json zeroes them and renormalizes
        with open(os.path.join(out_dir, "ensemble_probe.json"), "w") as f:
            json.dump({"weights": avg_w, "classes": class_names}, f, indent=1)
        servable = {k: (0.0 if k.endswith("_raw") else v) for k, v in avg_w.items()}
        total_s = sum(servable.values()) or 1.0
        avg_w = {k: v / total_s for k, v in servable.items()}
    with open(os.path.join(out_dir, "ensemble.json"), "w") as f:
        json.dump({"weights": avg_w, "classes": class_names}, f, indent=1)
    return rows


def run_cv(
    root: str = ".",
    cfg: PipelineConfig = PipelineConfig(),
    include_host: bool = True,
    feature_set: str = "clean",
    include_seq: bool = False,
    labels_taxonomy: str = "folder",
    seq_seeds: int = 1,
    seq_epochs: int = 80,
    ensemble_mlp: str = "none",
    seq_archs: tuple = ("cnn", "cnn_bilstm", "transformer", "transformer_lr1e3",
                        "transformer_mix4_lr1e3"),
    seq_tta_crops: tuple = (),
    seq_raw_archs: tuple = (),
    seq_class_balanced: bool = False,
    *,
    device: torch.device | str = "cuda",
) -> dict:
    """Engine B: the 5-fold CV production table (ref: main.py:872-1006).

    feature_set: 'clean' (reference protocol), 'raw', or 'both' (raw+clean
    concatenation).  labels_taxonomy: 'folder' (reference protocol) or
    '5class' (folders map into the 5-class dysfluency taxonomy, 5 outputs).
    Writes FINAL_PERFORMANCE_TABLE.csv,
    final_performance.html, scaler_after.npz, label_encoder.json,
    model_mlp_tpu.{npz,json}, permutation_importance_mlp_tpu.{csv,html}, the
    single-split confusion_<model>.csv and confusion_matrices.html, and with
    sklearn the zoo's rows, permutation_importance_rf.{csv,html} and the
    reference's pickles.

    include_seq: also the sequence heads (`_run_seq_members`), on the clips
    with clear_audio WAVs and folds of their own: a '<ARCH>-TPU' row per
    member of seq_archs (the default quint: cnn, cnn_bilstm and the three
    transformer recipes), each trained as folds x seq_seeds grids for
    seq_epochs epochs; their out-of-fold probabilities (oof_probas.npz);
    the nested weighted vote ('Weighted-Vote-TPU', ensemble_weights.json);
    and the servable quint: each member refit on all rows
    (model_<arch>.{npz,json}, model_<arch>_norm.npz) and ensemble.json.
    ensemble_mlp: an MLP member of the vote, 'none', 'clean' or 'both'
    (raw+clean features; clean-only when raw ones are undecodable), refit
    and persisted as model_mlp_<name>_tpu + scaler_<name>.npz.
    seq_tta_crops: also '<ARCH>-TPU+TTA' and 'Weighted-Vote-TPU+TTA' rows
    from start/end-cropped views of the same grids.  seq_raw_archs: probe
    members trained on the raw (pre-denoise) decode of the same rows
    ('<ARCH>-RAW-TPU' rows, '<arch>_raw' in the vote); their weights go to
    ensemble_probe.json and are zeroed in ensemble.json, since no refit of
    them is persisted.  seq_class_balanced: inverse-class-frequency
    sampling for every member and refit.

    `stage_s`: wall seconds of the features, the CV grid (mlp_cv), the
    production fit and its save (mlp_fit), the MLP's permutation importance
    and each single_split_<model>; with include_seq also seq_clips,
    seq_cv_<arch> (each architecture's CV grids, their featurization and
    predictions), seq_vote (the MLP member's CV and the vote) and
    seq_fit_<arch> (each refit and its save)."""
    dev = resolve_device(device)
    out_dir = os.path.join(root, cfg.data.output_dir)
    os.makedirs(out_dir, exist_ok=True)
    # delete stale model pickles so feature-shape drift fails loudly at
    # inference instead of misclassifying (ref: main1.py:795-799)
    persist.clear_stale_artifacts(out_dir)

    timer = StageTimer()
    with timer.stage("features"):
        if feature_set == "both":
            X_raw, labels, _, ok_r = extract_corpus(root, cfg, "raw", device=dev)
            X_clean, _, _, ok_c = extract_corpus(root, cfg, "clean", device=dev)
            X, ok = np.concatenate([X_raw, X_clean], axis=1), ok_r & ok_c
        else:
            X, labels, _, ok = extract_corpus(root, cfg, feature_set, device=dev)
    if not ok.all():
        log.warning("dropping %d undecodable rows from engine B", int((~ok).sum()))
        X = X[ok]
        labels = [l for l, k in zip(labels, ok) if k]
    if not labels:
        raise RuntimeError("no decodable corpus rows; run preprocess first")
    labels, le = encode_labels(labels, labels_taxonomy)
    y = le.transform(labels)
    class_names = le.classes_

    scaler = StandardScaler.fit(X)
    Xs = scaler.transform(X).astype(np.float32)
    folds = stratified_kfold(y, cfg.train.n_folds, cfg.train.seed)
    persist.save_scaler(os.path.join(out_dir, "scaler_after.npz"), scaler)
    persist.save_label_encoder(os.path.join(out_dir, "label_encoder.json"), le)

    final_rows = []

    def add_row(name, y_pred):
        final_rows.append(_cv_row(name, y, y_pred, folds, len(class_names)))

    # the seed-ensembled MLP: the whole folds x seeds grid at once
    mlp_cfg = MLPTrainConfig(n_classes=len(class_names))
    with timer.stage("mlp_cv"):
        pred, _ = cross_validate_mlp(Xs, y, folds, mlp_cfg, device=dev)
    add_row("MLP-TPU", pred)
    log.info("MLP-TPU CV done in %.1fs: acc=%.1f%%", timer.totals["mlp_cv"],
             final_rows[-1]["Accuracy (%)"])

    rf_full = None
    for name, model in (_host_zoo("main", cfg.train.seed) if include_host else {}).items():
        y_pred = np.zeros_like(y)
        for tr_idx, te_idx in folds:
            model.fit(Xs[tr_idx], y[tr_idx])
            y_pred[te_idx] = model.predict(Xs[te_idx])
        add_row(name, y_pred)
        if name == "RandomForest":
            model.fit(Xs, y)  # refit on all data (ref main.py:946-948)
            rf_full = model

    if include_seq:
        final_rows += _run_seq_members(
            root, cfg, le, labels_taxonomy, out_dir, timer, dev, seq_seeds=seq_seeds,
            seq_epochs=seq_epochs, ensemble_mlp=ensemble_mlp, seq_archs=seq_archs,
            seq_tta_crops=seq_tta_crops, seq_raw_archs=seq_raw_archs,
            seq_class_balanced=seq_class_balanced)

    evals.write_final_performance_csv(os.path.join(out_dir, "FINAL_PERFORMANCE_TABLE.csv"),
                                      final_rows)
    report.write_html(
        os.path.join(out_dir, "final_performance.html"),
        "Final Performance (5-fold CV)",
        [report.bar_svg([r["Model"] for r in final_rows],
                        [r["Accuracy (%)"] for r in final_rows], "5-fold CV Accuracy")],
    )

    # the production model on all rows, plus the reference's pickle trio
    # (ref: main.py:889-890, 948)
    with timer.stage("mlp_fit"):  # save_mlp's copy to the host ends the stage
        fitted = fit_mlp(Xs, y, mlp_cfg, device=dev)
        persist.save_mlp(os.path.join(out_dir, "model_mlp_tpu"), fitted)
    persist.save_sklearn_artifacts(out_dir, scaler=scaler, le=le, rf=rf_full)

    names = cfg.features.feature_names()
    if feature_set == "both":
        names = [f"raw_{n}" for n in names] + [f"clean_{n}" for n in names]

    def write_importance(fname, imp_mean, imp_std, title):
        order = np.argsort(-imp_mean)[:20]
        write_csv(os.path.join(out_dir, fname), ["feature", "importance", "std"],
                  [[names[i], float(imp_mean[i]), float(imp_std[i])] for i in order])
        report.write_html(
            os.path.join(out_dir, fname.replace(".csv", ".html")), title,
            [report.bar_svg([names[i] for i in order], [float(imp_mean[i]) for i in order],
                            title, unit="")],
        )

    # permutation importance of the refit RF -- the reference's artifact
    # (ref: main.py:976-989: n_repeats=10, random_state=42, n_jobs=-1)
    if rf_full is not None:
        from sklearn.inspection import permutation_importance

        r = permutation_importance(rf_full, Xs, y, n_repeats=10, random_state=cfg.train.seed,
                                   n_jobs=-1)
        write_importance("permutation_importance_rf.csv", r.importances_mean,
                         r.importances_std, "Permutation importance (RandomForest)")

    # ... and of the production MLP, under its own name
    from stutter_tpu_torch.importance import permutation_importance_tpu

    with timer.stage("mlp_importance"):
        imp_mean, imp_std = permutation_importance_tpu(fitted, Xs, y, n_repeats=10,
                                                       seed=cfg.train.seed)
    log.info("MLP-TPU permutation importance done in %.1fs", timer.totals["mlp_importance"])
    write_importance("permutation_importance_mlp_tpu.csv", imp_mean, imp_std,
                     "Permutation importance (MLP-TPU)")

    # single-split confusion matrices (ref: main.py:992-1006)
    tr, te = stratified_train_test_split(y, cfg.train.test_size, cfg.train.seed)
    single = {"MLP-TPU": _TpuMLPAdapter(mlp_cfg, dev)}
    if include_host:
        single.update({k: v for k, v in _host_zoo("main", cfg.train.seed).items()
                       if k != "Ensemble"})
    cm_svgs = []
    for name, model in single.items():
        try:
            with timer.stage(f"single_split_{name}"):
                model.fit(Xs[tr], y[tr])
                p = model.predict(Xs[te])
        except Exception as e:  # noqa: BLE001 - a host model degrades its own matrix
            if isinstance(model, _TpuMLPAdapter):
                raise
            log.error("single-split confusion failed for %s: %s", name, e)
            continue
        cm = evals.confusion_matrix(y[te], p, len(class_names))
        evals.write_confusion_csv(os.path.join(out_dir, f"confusion_{name}.csv"), cm, class_names)
        cm_svgs.append((name, cm))
    if cm_svgs:
        report.write_html(
            os.path.join(out_dir, "confusion_matrices.html"),
            "Confusion Matrices (single split)",
            [report.confusion_svg(cm, class_names, name) for name, cm in cm_svgs],
        )
    timer.log_report()
    return {"final_rows": final_rows, "classes": class_names, "scaler": scaler, "le": le,
            "mlp": fitted, "folds": folds, "stage_s": dict(timer.totals)}
