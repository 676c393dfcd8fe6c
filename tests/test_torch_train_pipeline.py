"""The port's engine B (run_cv) and engine A (run_before_after) against the
JAX package's on the tones-vs-noise workspace of tests/test_pipeline_e2e.py,
on the CPU: the same files, CSV headers, row names and folds; then the
port's Predictor serves what it trained, and the CLI's train / train-ab run.

Both packages train on the same feature rows: the port preprocesses and
extracts, and each JAX workspace gets a copy of its clear_audio/ and
cache_features/.  The MLP trains shrunk (30 epochs, 2 seeds: each
package's pipeline.MLPTrainConfig patched, as tests/test_pipeline_e2e.py
does) and the sklearn zoo with few trees and iterations (the same names
and kinds), so the module runs in about a minute; the zoo's published
hyperparameters are held equal in tests/test_torch_isolation.py."""

import csv
import os
import shutil

import numpy as np
import pytest
import torch

from stutter_tpu import config as jconfig
from stutter_tpu_torch.config import PipelineConfig
from stutter_tpu_torch.io.wav import write_wav

torch.set_num_threads(2)

CFG, JCFG = PipelineConfig(), jconfig.PipelineConfig()
# folder names of the 5-class run: they map to repetition and block
TAXONOMY = {"tonal": "word repetition", "noisy": "block"}


def _write_corpus(root):
    """tests/test_pipeline_e2e.py's tiny 2-class corpus: tones vs noise."""
    rng = np.random.RandomState(0)
    sr = 16000
    for cls, kind in (("tonal", "tone"), ("noisy", "noise")):
        d = root / "segrigated_samples" / cls
        d.mkdir(parents=True)
        for i in range(10):
            n = rng.randint(8000, 20000)
            if kind == "tone":
                y = 0.5 * np.sin(2 * np.pi * rng.uniform(200, 900) * np.arange(n) / sr)
            else:
                y = rng.randn(n) * 0.2
            write_wav(d / f"clip_{cls}_{i}.wav", y.astype(np.float32), sr)


def _small_zoo(original):
    """The zoo with few trees and iterations: the same names and kinds."""
    def zoo(variant="main", seed=42):
        models = original(variant, seed)
        ests = [m for m in models.values() if not hasattr(m, "models")]
        ests += [m for v in models.values() for m in getattr(v, "models", [])]
        for m in ests:
            kw = {"n_estimators": 8, "n_jobs": 1} if "n_estimators" in m.get_params() else {}
            if "max_iter" in m.get_params() and "hidden_layer_sizes" in m.get_params():
                kw = {"max_iter": 60}
            m.set_params(**kw)
        return models
    return zoo


def _shrink_mlp(mp, pkg):
    """pkg.pipeline's MLPTrainConfig at 30 epochs and 2 seeds."""
    orig = pkg.MLPTrainConfig
    mp.setattr(pkg, "MLPTrainConfig", lambda **kw: orig(epochs=30, n_seeds=2, **kw))


def _copy(src, dst):
    for d in ("segrigated_samples", "clear_audio", "cache_features"):
        shutil.copytree(src / d, dst / d)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from stutter_tpu import pipeline as J
    from stutter_tpu.models import host_baselines as jzoo
    from stutter_tpu_torch import pipeline as P
    from stutter_tpu_torch.models import host_baselines as tzoo

    base = tmp_path_factory.mktemp("base")
    _write_corpus(base)
    P.preprocess(str(base), CFG, device="cpu")
    for sfx in ("raw", "clean"):
        P.extract_corpus(str(base), CFG, sfx, device="cpu")
    tax = tmp_path_factory.mktemp("tax")
    (tax / "segrigated_samples").mkdir()
    for old, new in TAXONOMY.items():
        shutil.copytree(base / "segrigated_samples" / old, tax / "segrigated_samples" / new)
    for d in ("clear_audio", "cache_features"):  # keyed by stem: the same rows
        shutil.copytree(base / d, tax / d)

    roots, out = {}, {}
    for who in ("torch", "jax"):
        for case in ("host", "nohost", "5class"):
            roots[who, case] = tmp_path_factory.mktemp(f"{who}_{case}")
            _copy(tax if case == "5class" else base, roots[who, case])
    with pytest.MonkeyPatch.context() as mp:
        for zoo in (jzoo, tzoo):
            mp.setattr(zoo, "reference_model_zoo", _small_zoo(zoo.reference_model_zoo))
        for pkg in (J, P):
            _shrink_mlp(mp, pkg)
        for case, kw in (("host", {}), ("nohost", {"include_host": False}),
                         ("5class", {"include_host": False, "labels_taxonomy": "5class"})):
            out["torch", case] = P.run_cv(str(roots["torch", case]), CFG, device="cpu", **kw)
            out["jax", case] = J.run_cv(str(roots["jax", case]), JCFG, **kw)
        out["torch", "ab"] = P.run_before_after(str(roots["torch", "host"]), CFG, device="cpu")
        out["jax", "ab"] = J.run_before_after(str(roots["jax", "host"]), JCFG)
    return {"roots": roots, "out": out, "base": base}


def _outputs(root):
    return sorted(os.listdir(root / "output_results"))


def _csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.mark.parametrize("case", ["host", "nohost", "5class"])
def test_run_cv_writes_the_jax_packages_files(runs, case):
    """The same files; each CSV's header and, where rows are named, the
    same names in the same order (importance rows are ranked by each
    model's own values, so only their count is compared)."""
    t, j = runs["roots"]["torch", case], runs["roots"]["jax", case]
    assert _outputs(t) == _outputs(j)
    for name in _outputs(t):
        if not name.endswith(".csv"):
            continue
        (th, tr), (jh, jr) = _csv(t / "output_results" / name), _csv(j / "output_results" / name)
        assert th == jh, name
        assert len(tr) == len(jr), name
        if name.startswith("permutation_importance") or name.startswith("roc_"):
            continue
        n_named = 2 if name.startswith(("auc_", "metrics_summary")) else 1
        assert [r[:n_named] for r in tr] == [r[:n_named] for r in jr], name
    files = set(_outputs(t))
    assert {"FINAL_PERFORMANCE_TABLE.csv", "final_performance.html", "scaler_after.npz",
            "label_encoder.json", "model_mlp_tpu.npz", "model_mlp_tpu.json",
            "permutation_importance_mlp_tpu.csv", "permutation_importance_mlp_tpu.html",
            "confusion_MLP-TPU.csv", "confusion_matrices.html"} <= files
    if case == "host":
        assert {"permutation_importance_rf.csv", "model_rf.pkl", "scaler_after.pkl",
                "label_encoder.pkl", "confusion_RandomForest.csv"} <= files
    else:
        assert "model_rf.pkl" not in files and "confusion_SVM.csv" not in files


@pytest.mark.parametrize("case", ["host", "nohost", "5class"])
def test_run_cv_rows_folds_and_artifacts_equal_the_jax_run(runs, case):
    from stutter_tpu.train.splits import stratified_kfold as jkfold

    t, j = runs["out"]["torch", case], runs["out"]["jax", case]
    assert t["classes"] == j["classes"]
    if case == "5class":
        assert t["classes"] == sorted(["repetition", "prolongation", "block", "interjection",
                                       "fluent"])
    names = [r["Model"] for r in t["final_rows"]]
    assert names == [r["Model"] for r in j["final_rows"]]
    assert names == (["MLP-TPU", "RandomForest", "MLP", "SVM", "Ensemble"] if case == "host"
                     else ["MLP-TPU"])
    # the same folds: the JAX package's splits of its own encoded labels
    from stutter_tpu.data import encode_labels
    from stutter_tpu.pipeline import extract_corpus

    _, labels, _, _ = extract_corpus(str(runs["roots"]["jax", case]), JCFG, "clean")
    labels, le = encode_labels(labels, "5class" if case == "5class" else "folder")
    assert len(t["folds"]) == 5
    for (a, b), (c, d) in zip(t["folds"], jkfold(le.transform(labels), 5, 42), strict=True):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    tr, jr = runs["roots"]["torch", case] / "output_results", runs["roots"]["jax", case] / "output_results"
    for f in ("label_encoder.json", "model_mlp_tpu.json"):
        assert (tr / f).read_text() == (jr / f).read_text(), f
    with np.load(tr / "scaler_after.npz") as a, np.load(jr / "scaler_after.npz") as b:
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # tones vs noise is separable: both MLPs near the top
    assert t["final_rows"][0]["Accuracy (%)"] >= 90 and j["final_rows"][0]["Accuracy (%)"] >= 90


def test_run_before_after_matches_the_jax_run(runs):
    t, j = runs["out"]["torch", "ab"], runs["out"]["jax", "ab"]
    assert [(m["dataset"], m["model"]) for m in t["metrics"]] == [
        (m["dataset"], m["model"]) for m in j["metrics"]]
    assert [m["model"] for m in t["metrics"]][:4] == ["MLP-TPU", "RandomForest", "MLP", "SVM"]
    np.testing.assert_array_equal(t["y_test"], j["y_test"])
    after = {m["model"]: m["accuracy"] for m in t["metrics"] if m["dataset"] == "after"}
    assert after["MLP-TPU"] >= 90
    tr = runs["roots"]["torch", "host"] / "output_results"
    for name in ("metrics_summary.html", "roc_after.html", "confusion_before.html",
                 "feature_importances_after_rf.csv", "train_test_sizes.csv"):
        assert (tr / name).exists(), name


def test_entry_points_report_their_stage_seconds(runs):
    """run_cv and run_before_after return each stage's wall seconds: the
    trainer's grids, the importance and every model's single-split or
    per-set fit, the host zoo's only where it ran."""
    out = runs["out"]
    for case in ("host", "nohost"):
        stages = out["torch", case]["stage_s"]
        want = {"features", "mlp_cv", "mlp_fit", "mlp_importance", "single_split_MLP-TPU"}
        if case == "host":
            want |= {"single_split_RandomForest", "single_split_SVM"}
        assert want <= set(stages) and all(v > 0 for v in stages.values())
        assert ("single_split_RandomForest" in stages) == (case == "host")
    stages = out["torch", "ab"]["stage_s"]
    assert {"features", "before_MLP-TPU", "after_MLP-TPU", "after_RandomForest"} <= set(stages)
    assert all(v > 0 for v in stages.values())


def test_predictor_serves_the_trained_model(runs):
    from stutter_tpu_torch.infer import Predictor

    base = runs["base"] / "segrigated_samples"
    for case in ("host", "nohost"):
        pred = Predictor.load(str(runs["roots"]["torch", case] / "output_results"), CFG,
                              device="cpu")
        for cls in ("tonal", "noisy"):
            r = pred.predict_file(str(base / cls / f"clip_{cls}_3.wav"))
            assert r["label"] == cls and abs(sum(r["proba"].values()) - 1) < 1e-5


def test_cli_train_and_train_ab(runs, tmp_path, capsys):
    """`train --no-host` and `train-ab` on the CPU (the MLP and the zoo
    shrunk as above) print the JAX CLI's lines; without --device cpu and
    without a GPU they raise before writing anything; `train` offers the
    sequence heads' flags (tests/test_torch_seq_pipeline.py runs them)."""
    from stutter_tpu_torch import cli, pipeline
    from stutter_tpu_torch.models import host_baselines as tzoo

    root = tmp_path / "ws"
    _copy(runs["base"], root)
    with pytest.MonkeyPatch.context() as mp:
        _shrink_mlp(mp, pipeline)
        mp.setattr(tzoo, "reference_model_zoo", _small_zoo(tzoo.reference_model_zoo))
        assert cli.main(["train", "--root", str(root), "--no-host", "--device", "cpu"]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1 and lines[0].startswith("MLP-TPU        acc=")
        with open(root / "output_results" / "model_mlp_tpu.json") as f:
            assert f.read() == '{"n_seeds": 2, "hidden": [256, 128, 64], "n_classes": 2}'
        assert cli.main(["train-ab", "--root", str(root), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [l.split()[:2] for l in lines] == [[d, m] for d in ("before", "after")
                                              for m in ("MLP-TPU", "RandomForest", "MLP", "SVM")]
    if not torch.cuda.is_available():
        empty = tmp_path / "empty"
        for cmd in ("train", "train-ab"):
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                cli.main([cmd, "--root", str(empty)])
        assert not empty.exists()
    with pytest.raises(SystemExit):
        cli.main(["train", "--help"])
    usage = capsys.readouterr().out
    for flag in ("--seq", "--seq-seeds", "--ensemble-mlp", "--seq-tta-crop", "--seq-balanced",
                 "--seq-raw-arch"):
        assert f"{flag} " in usage, flag
