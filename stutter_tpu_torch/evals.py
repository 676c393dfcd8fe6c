"""Evaluation metrics and CSV artifacts (counterpart of stutter_tpu/evals.py),
NumPy only.

Every metric the reference computes through sklearn (ref:
pipeline1.py:508-600, main.py:918-1006): accuracy, log-loss, macro
precision/recall/F1, confusion matrix, per-class ROC/AUC and the
classification report.  One CSV writer, `write_csv`: plain comma-separated
rows, a cell quoted only when it holds a comma or a quote, so both packages
write the same bytes under the same file names.
"""

from __future__ import annotations

import os

import numpy as np


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def log_loss(y_true: np.ndarray, proba: np.ndarray, eps: float = 1e-15) -> float:
    """sklearn-compatible multiclass log loss (clip + renormalize)."""
    p = np.clip(np.asarray(proba, np.float64), eps, 1.0 - eps)
    p /= p.sum(axis=1, keepdims=True)
    rows = np.arange(len(y_true))
    return float(-np.mean(np.log(p[rows, np.asarray(y_true)])))


def confusion_matrix(y_true, y_pred, n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), np.int64)
    for t, p in zip(np.asarray(y_true), np.asarray(y_pred)):
        cm[int(t), int(p)] += 1
    return cm


def precision_recall_fscore(
    y_true, y_pred, n_classes: int, average: str | None = "macro"
):
    """Matches sklearn precision_recall_fscore_support(zero_division=0)."""
    cm = confusion_matrix(y_true, y_pred, n_classes)
    tp = np.diag(cm).astype(np.float64)
    pred_tot = cm.sum(axis=0).astype(np.float64)
    true_tot = cm.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(pred_tot > 0, tp / pred_tot, 0.0)
        rec = np.where(true_tot > 0, tp / true_tot, 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    support = true_tot.astype(np.int64)
    if average == "macro":
        return float(prec.mean()), float(rec.mean()), float(f1.mean()), int(support.sum())
    if average == "weighted":
        wsum = max(support.sum(), 1)
        return (
            float((prec * support).sum() / wsum),
            float((rec * support).sum() / wsum),
            float((f1 * support).sum() / wsum),
            int(support.sum()),
        )
    return prec, rec, f1, support


def roc_curve(y_true_bin: np.ndarray, score: np.ndarray, drop_intermediate: bool = True):
    """(fpr, tpr, thresholds) for a binary problem, sklearn semantics:
    descending unique thresholds, prepended +inf point, and (by default)
    sklearn's `drop_intermediate` removal of collinear suboptimal points --
    so roc_*.csv point sets are row-compatible with reference-generated
    output (ref plot_roc, pipeline1.py:303-324)."""
    y = np.asarray(y_true_bin).astype(bool)
    s = np.asarray(score, np.float64)
    order = np.argsort(-s, kind="mergesort")
    y, s = y[order], s[order]
    distinct = np.where(np.diff(s))[0]
    threshold_idxs = np.r_[distinct, len(s) - 1]
    tps = np.cumsum(y)[threshold_idxs].astype(np.float64)
    fps = (1 + threshold_idxs) - tps
    thr = s[threshold_idxs]
    if drop_intermediate and len(fps) > 2:
        optimal = np.where(
            np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        )[0]
        fps, tps, thr = fps[optimal], tps[optimal], thr[optimal]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thr = np.r_[np.inf, thr]
    n_pos = max(y.sum(), 1)
    n_neg = max((~y).sum(), 1)
    return fps / n_neg, tps / n_pos, thr


def auc_score(y_true_bin: np.ndarray, score: np.ndarray) -> float:
    # dropped points are exactly collinear, so the trapezoid is unchanged;
    # compute on the full curve anyway for bit-stability
    fpr, tpr, _ = roc_curve(y_true_bin, score, drop_intermediate=False)
    return float(np.trapezoid(tpr, fpr))


def per_class_auc(y_true: np.ndarray, proba: np.ndarray) -> list[float]:
    """One-vs-rest AUC per class (ref plot_roc, pipeline1.py:303-324)."""
    n_classes = proba.shape[1]
    return [auc_score(np.asarray(y_true) == c, proba[:, c]) for c in range(n_classes)]


def classification_report_dict(y_true, y_pred, class_names: list[str]) -> dict:
    """sklearn classification_report(output_dict=True) equivalent."""
    n = len(class_names)
    prec, rec, f1, support = precision_recall_fscore(y_true, y_pred, n, average=None)
    rep = {}
    for i, name in enumerate(class_names):
        rep[name] = {
            "precision": float(prec[i]),
            "recall": float(rec[i]),
            "f1-score": float(f1[i]),
            "support": int(support[i]),
        }
    rep["accuracy"] = accuracy(y_true, y_pred)
    for avg in ("macro", "weighted"):
        p, r, f, s = precision_recall_fscore(y_true, y_pred, n, average=avg)
        rep[f"{avg} avg"] = {"precision": p, "recall": r, "f1-score": f, "support": s}
    return rep


# ---------------------------------------------------------------------------
# CSV artifacts (the reference's file names, SURVEY.md C18)
# ---------------------------------------------------------------------------


def write_csv(path: str, header: list[str], rows: list[list]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(str(h) for h in header) + "\n")
        for r in rows:
            f.write(",".join(_csv_cell(v) for v in r) + "\n")


def _csv_cell(v) -> str:
    s = str(v)
    if "," in s or '"' in s:
        s = '"' + s.replace('"', '""') + '"'
    return s


def write_confusion_csv(path: str, cm: np.ndarray, class_names: list[str]) -> None:
    write_csv(path, [""] + list(class_names), [[name, *cm[i]] for i, name in enumerate(class_names)])


def write_classification_report_csv(path: str, rep: dict) -> None:
    rows = []
    for key, val in rep.items():
        if key == "accuracy":
            rows.append([key, "", "", val, ""])
        else:
            rows.append([key, val["precision"], val["recall"], val["f1-score"], val["support"]])
    write_csv(path, ["", "precision", "recall", "f1-score", "support"], rows)


def write_auc_csv(path: str, rows: list[dict]) -> None:
    write_csv(path, ["model", "class", "auc"], [[r["model"], r["class"], r["auc"]] for r in rows])


def write_roc_points_csv(path: str, rows: list[dict]) -> None:
    write_csv(
        path,
        ["model", "class", "fpr", "tpr", "threshold"],
        [[r["model"], r["class"], r["fpr"], r["tpr"], r["threshold"]] for r in rows],
    )


def write_metrics_summary_csv(path: str, rows: list[dict]) -> None:
    write_csv(
        path,
        ["dataset", "model", "accuracy", "test_loss"],
        [[r["dataset"], r["model"], r["accuracy"], r["test_loss"]] for r in rows],
    )


FINAL_COLUMNS = ["Model", "Accuracy (%)", "Precision (%)", "Recall (%)", "F1-Score (%)"]


def write_final_performance_csv(path: str, rows: list[dict]) -> None:
    write_csv(path, FINAL_COLUMNS, [[r[c] for c in FINAL_COLUMNS] for r in rows])
