"""The port stands alone: nothing under stutter_tpu_torch/, and not
chip_smoke.py, imports the JAX package or JAX, and each copy the port keeps
of a JAX-package module (config, data and its label taxonomy, cache,
evals' metrics and CSV writers, report, train.splits with and without
sklearn, models.host_baselines, io.wav, io.mp3, the decoder registry, the
C++ WAV loader, ops.filterbanks, utils.profiling, serve's upload sniffing
and cap, persist's parameter flattening and sklearn helpers) gives what the
original gives; so do the public functions the port adds to its copies
(FeatureCache.get_or_compute and its collision gate, per_class_auc,
feature_importances_rf, the scaler's and encoder's inverses, load_mp3,
native_available, extract_features_149_numpy)."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from stutter_tpu import config as jconfig
from stutter_tpu_torch import config as tconfig

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "stutter_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_of_the_port_imports_the_jax_package_or_jax(path):
    bad = {n for n in _imported_modules(path)
           if n.split(".")[0] in ("stutter_tpu", "jax", "jaxlib")}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_importing_and_running_the_port_loads_neither():
    """Every port module and chip_smoke imported, then one CPU predict_clip
    from artifacts the port writes: sys.modules holds no stutter_tpu and no
    jax entry."""
    code = """
import importlib, os, pkgutil, sys, tempfile
import numpy as np
import stutter_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')
         if not m.name.endswith('__main__')]
for n in names:
    importlib.import_module(n)
import chip_smoke
from stutter_tpu_torch import persist
from stutter_tpu_torch.config import PipelineConfig
from stutter_tpu_torch.infer import Predictor
from stutter_tpu_torch.models.mlp import SeedMLP
from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler
rng = np.random.RandomState(0)
dims = (149, 8, 3)
params = {}
for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
    params[f"w{i}"] = rng.randn(2, a, b).astype(np.float32) * 0.1
    params[f"b{i}"] = np.zeros((2, b), np.float32)
with tempfile.TemporaryDirectory() as d:
    persist.save_mlp(os.path.join(d, "model_mlp_tpu"),
                     SeedMLP.from_jax_params(params, device="cpu"))
    persist.save_scaler(os.path.join(d, "scaler_after.npz"),
                        StandardScaler.fit(rng.randn(5, 149).astype(np.float32)))
    persist.save_label_encoder(os.path.join(d, "label_encoder.json"),
                               LabelEncoder(classes_=["a", "b", "c"]))
    r = Predictor.load(d, PipelineConfig(), device="cpu").predict_clip(
        (0.1 * rng.randn(9000)).astype(np.float32))
assert abs(sum(r["proba"].values()) - 1) < 1e-5, r
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("stutter_tpu", "jax", "jaxlib"))
assert not bad, bad
assert len(names) >= 43, names
need = {'serve', 'train.seq_pipeline', 'train.seq_trainer', 'models.cnn', 'models.cnn_bilstm',
        'models.transformer', 'train.trainer', 'train.splits', 'importance', 'report',
        'models.host_baselines'}
assert {'stutter_tpu_torch.' + n for n in need} <= set(names), names
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


_CONFIGS = ["FrontendConfig", "FeatureConfig", "DenoiseConfig", "DataConfig", "TrainConfig",
            "PipelineConfig"]


@pytest.mark.parametrize("name", _CONFIGS)
def test_config_defaults_equal_the_jax_package(name):
    ours, theirs = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in
                                                          dataclasses.fields(theirs)]


@pytest.mark.parametrize("name", ["FEATURES_149", "FEATURES_334"])
def test_feature_variants_equal_the_jax_package(name):
    ours, theirs = getattr(tconfig, name), getattr(jconfig, name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.total_feature_len == theirs.total_feature_len
    assert ours.feature_names() == theirs.feature_names()
    assert ours.frontend.num_frames(48000) == theirs.frontend.num_frames(48000)


@pytest.mark.parametrize("n_fft", [2048, 1024, 512])
def test_filterbanks_equal_the_jax_package(n_fft):
    from stutter_tpu.ops import filterbanks as J
    from stutter_tpu_torch.ops import filterbanks as P

    np.testing.assert_array_equal(P.hann(n_fft), J.hann(n_fft))
    for n_mels in (128, 40):
        np.testing.assert_array_equal(P.mel_fb(16000, n_fft, n_mels), J.mel_fb(16000, n_fft, n_mels))
    np.testing.assert_array_equal(P.chroma_fb_table(16000, n_fft, 12),
                                  J.chroma_fb_table(16000, n_fft, 12))
    for n_mfcc, n_mels in ((20, 128), (40, 128)):
        np.testing.assert_array_equal(P.dct_mat(n_mfcc, n_mels), J.dct_mat(n_mfcc, n_mels))
    np.testing.assert_array_equal(P.tuning_bin_edges(), J.tuning_bin_edges())
    for order in (1, 2):
        ours, theirs = P.savgol_ops(9, order), J.savgol_ops(9, order)
        for field in ("interior", "first", "last"):
            np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))


@pytest.mark.parametrize("dim", [149, 286])
@pytest.mark.parametrize("suffix", ["raw", "clean"])
def test_cache_names_equal_the_jax_package(tmp_path, dim, suffix):
    from stutter_tpu import cache as jcache
    from stutter_tpu import data as jdata
    from stutter_tpu_torch import cache, data

    audio = "/corpus/segrigated_samples/block/clip_0007.mp3"
    assert data.cache_path("cf", audio, suffix, dim) == jdata.cache_path("cf", audio, suffix, dim)
    ours = cache.FeatureCache(str(tmp_path / "ours"), dim)
    theirs = jcache.FeatureCache(str(tmp_path / "theirs"), dim)
    assert os.path.basename(ours.path_for(audio, suffix)) == os.path.basename(
        theirs.path_for(audio, suffix))
    v = np.arange(dim, dtype=np.float32)
    ours.store(audio, suffix, v)  # one package writes, the other reads
    np.testing.assert_array_equal(
        jcache.FeatureCache(str(tmp_path / "ours"), dim).load(audio, suffix), v)
    assert data.label_of(audio) == jdata.label_of(audio) == "block"


def test_corpus_listing_and_csv_equal_the_jax_package(tmp_path):
    from stutter_tpu import data as jdata
    from stutter_tpu import evals as jevals
    from stutter_tpu_torch import data, evals

    for rel in ("a/x.wav", "a/y.MP3", "b/z.ogg", "b/skip.txt", "c/d/w.flac"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    assert data.list_audio_files(str(tmp_path)) == jdata.list_audio_files(str(tmp_path))
    header, rows = ["file", "label", "x"], [["a,b.wav", 'say "hi"', 0.5], ["c.wav", "d", 1e-9]]
    evals.write_csv(str(tmp_path / "ours.csv"), header, rows)
    jevals._write_csv(str(tmp_path / "theirs.csv"), header, rows)
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "theirs.csv").read_bytes()


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
def test_wav_files_cross_between_the_packages(tmp_path, subtype):
    from stutter_tpu.io import wav as jwav
    from stutter_tpu_torch.io import wav

    rng = np.random.RandomState(3)
    mono = (0.4 * rng.randn(3001)).astype(np.float32)
    stereo = (0.3 * rng.randn(1200, 2)).astype(np.float32)
    for writer, reader in ((wav, jwav), (jwav, wav)):
        for name, y in (("mono", mono), ("stereo", stereo)):
            path = tmp_path / f"{writer.__name__.split('.')[0]}_{name}.wav"
            writer.write_wav(path, y, 22050, subtype=subtype)
            got, sr = reader.read_wav(path)
            ref, ref_sr = writer.read_wav(path)
            assert sr == ref_sr == 22050
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(reader.load_mono(path)[0], writer.load_mono(path)[0])
    with pytest.raises(ValueError, match="resample"):
        wav.load_mono(tmp_path / "stutter_tpu_torch_mono.wav", sr=16000)


def test_native_loader_builds_in_the_port_and_reads_like_the_jax_one(tmp_path):
    """The port's C++ loader builds under stutter_tpu_torch/_build (never
    into the JAX package's tree) and decodes a batch as the Python reader
    does; an unreadable row is zeros with length 0."""
    from stutter_tpu_torch.io import native
    from stutter_tpu_torch.io.wav import read_wav, write_wav

    assert native.library_path().parent == REPO / "stutter_tpu_torch" / "_build"
    if native._build_and_load() is None:
        pytest.skip("no C++ compiler: the loader falls back to the Python reader")
    rng = np.random.RandomState(4)
    paths = []
    for i, n in enumerate((5000, 12000)):
        paths.append(str(tmp_path / f"c{i}.wav"))
        write_wav(paths[-1], (0.3 * rng.randn(n)).astype(np.float32), 16000)
    (tmp_path / "bad.wav").write_bytes(b"RIFF....")
    audio, lengths = native.load_wav_batch([*paths, str(tmp_path / "bad.wav")], 16384, 16000,
                                            device="cpu")
    for i, p in enumerate(paths):
        y, _ = read_wav(p)
        assert lengths[i] == len(y)
        np.testing.assert_array_equal(audio[i, :len(y)], y)
    assert lengths[2] == 0 and not audio[2].any()


def test_mp3_decoder_matches_the_jax_package():
    """Both load libmpg123 or neither does; where it exists, an undecodable
    file raises in both."""
    from stutter_tpu.io import mp3 as jmp3
    from stutter_tpu_torch.io import mp3

    assert mp3.available() == jmp3.available()
    if mp3.available():
        for mod in (mp3, jmp3):
            with pytest.raises(RuntimeError):
                mod.decode_mp3(str(REPO / "README.md"))


def test_stage_timer_reports_like_the_jax_package():
    from stutter_tpu.utils.profiling import StageTimer as JTimer
    from stutter_tpu_torch.utils.profiling import StageTimer

    ours, theirs = StageTimer(), JTimer()
    for t in (ours, theirs):
        t.totals.update({"decode": 1.5, "extract": 0.25})
        t.counts.update({"decode": 3, "extract": 1})
    assert ours.report() == theirs.report()


@pytest.mark.parametrize("prefix", [b"RIFF\x24\x08\x00\x00WAVE", b"ID3\x04\x00", b"\xff\xfb\x90\x00",
                                    b"\xff\xe3", b"\x00\x00\x00\x20ftypM4A ", b"OggS\x00",
                                    b"", b"\xff", b"RIF"])
def test_upload_sniffing_and_cap_equal_the_jax_service(prefix):
    from stutter_tpu import serve as jserve
    from stutter_tpu_torch import serve

    assert serve._sniff_suffix(prefix) == jserve._sniff_suffix(prefix)
    assert serve.MAX_UPLOAD_BYTES == jserve.MAX_UPLOAD_BYTES
    assert serve._INDEX_HTML.replace("stutter_tpu_torch", "stutter_tpu") == jserve._INDEX_HTML


def test_param_flattening_equals_the_jax_package():
    from stutter_tpu import persist as jpersist
    from stutter_tpu_torch import persist

    tree = {"w0": np.ones((2, 3)), "blk": {"wq": np.zeros(4), "ln": {"g": np.arange(3.0)}}}
    flat = persist._flatten_params(tree)
    assert flat.keys() == jpersist._flatten_params(tree).keys()
    back, jback = persist._unflatten_params(flat), jpersist._unflatten_params(flat)
    assert back.keys() == jback.keys() and back["blk"]["ln"].keys() == jback["blk"]["ln"].keys()
    np.testing.assert_array_equal(back["blk"]["ln"]["g"], tree["blk"]["ln"]["g"])


@pytest.mark.parametrize("have_sklearn", [True, False])
def test_splits_equal_the_jax_package(monkeypatch, have_sklearn):
    """sklearn's splits where it is installed, the seeded fallback where it
    is not (the card's case): the same indices in both packages."""
    from stutter_tpu.train import splits as J
    from stutter_tpu_torch.train import splits as P

    assert P.HAVE_SKLEARN == J.HAVE_SKLEARN
    monkeypatch.setattr(P, "HAVE_SKLEARN", have_sklearn)
    monkeypatch.setattr(J, "HAVE_SKLEARN", have_sklearn)
    y = np.random.RandomState(0).randint(0, 3, 905)
    for n_splits, seed in ((5, 42), (3, 7)):
        for (a, b), (c, d) in zip(P.stratified_kfold(y, n_splits, seed),
                                  J.stratified_kfold(y, n_splits, seed), strict=True):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    for got, ref in zip(P.stratified_train_test_split(y, 0.2, 42),
                        J.stratified_train_test_split(y, 0.2, 42)):
        np.testing.assert_array_equal(got, ref)


def test_metrics_equal_the_jax_package():
    from stutter_tpu import evals as J
    from stutter_tpu_torch import evals as P

    rng = np.random.RandomState(1)
    y = rng.randint(0, 4, 200)
    proba = rng.dirichlet(np.ones(4), 200).astype(np.float32)
    pred = np.where(rng.rand(200) < 0.7, y, rng.randint(0, 4, 200))
    pred[pred == 3] = 2  # a class never predicted: zero_division
    assert P.accuracy(y, pred) == J.accuracy(y, pred)
    assert P.log_loss(y, proba) == J.log_loss(y, proba)
    np.testing.assert_array_equal(P.confusion_matrix(y, pred, 4), J.confusion_matrix(y, pred, 4))
    for avg in ("macro", "weighted", None):
        for a, b in zip(P.precision_recall_fscore(y, pred, 4, avg),
                        J.precision_recall_fscore(y, pred, 4, avg)):
            np.testing.assert_array_equal(a, b)
    score = np.round(proba[:, 1], 2)  # ties, as probabilities have
    for drop in (True, False):
        for a, b in zip(P.roc_curve(y == 1, score, drop), J.roc_curve(y == 1, score, drop)):
            np.testing.assert_array_equal(a, b)
    assert P.auc_score(y == 1, score) == J.auc_score(y == 1, score)
    names = ["a", "b,c", "d", "e"]
    assert P.classification_report_dict(y, pred, names) == J.classification_report_dict(
        y, pred, names)


def test_csv_writers_equal_the_jax_package(tmp_path):
    from stutter_tpu import evals as J
    from stutter_tpu_torch import evals as P

    rng = np.random.RandomState(2)
    y, pred = rng.randint(0, 3, 50), rng.randint(0, 3, 50)
    names = ["block", "word repetition", 'x "q"']
    rep = J.classification_report_dict(y, pred, names)
    fpr, tpr, thr = J.roc_curve(y == 0, rng.rand(50))
    calls = {
        "confusion": lambda m, p: m.write_confusion_csv(p, J.confusion_matrix(y, pred, 3), names),
        "report": lambda m, p: m.write_classification_report_csv(p, rep),
        "auc": lambda m, p: m.write_auc_csv(p, [{"model": "MLP-TPU", "class": n, "auc": 0.5}
                                                for n in names]),
        "roc": lambda m, p: m.write_roc_points_csv(p, [
            {"model": "SVM", "class": "block", "fpr": f, "tpr": t, "threshold": h}
            for f, t, h in zip(fpr, tpr, thr)]),
        "summary": lambda m, p: m.write_metrics_summary_csv(p, [
            {"dataset": "after", "model": "MLP", "accuracy": 91.5, "test_loss": 0.25}]),
        "final": lambda m, p: m.write_final_performance_csv(p, [
            {"Model": "MLP-TPU", "Accuracy (%)": 99.5, "Precision (%)": 99.0,
             "Recall (%)": 98.0, "F1-Score (%)": 97.5}]),
    }
    for name, call in calls.items():
        call(P, str(tmp_path / f"ours_{name}.csv"))
        call(J, str(tmp_path / f"theirs_{name}.csv"))
        assert (tmp_path / f"ours_{name}.csv").read_bytes() == (
            tmp_path / f"theirs_{name}.csv").read_bytes(), name


def test_report_svg_and_html_equal_the_jax_package(tmp_path):
    from stutter_tpu import report as J
    from stutter_tpu_torch import report as P

    rng = np.random.RandomState(3)
    curves = [{"label": f"m - <c{i}>", "fpr": np.sort(rng.rand(6)), "tpr": np.sort(rng.rand(6)),
               "auc": float(rng.rand())} for i in range(12)]
    cm = rng.randint(0, 40, (5, 5))
    names = ["repetition", "prolongation & co", "block", "interjection", "fluent"]
    assert P.roc_svg(curves, "ROC (after)") == J.roc_svg(curves, "ROC (after)")
    assert P.confusion_svg(cm, names, "MLP-TPU") == J.confusion_svg(cm, names, "MLP-TPU")
    labels, vals = [f"after/model_{i}" for i in range(7)], list(rng.rand(7) * 100)
    assert P.bar_svg(labels, vals, "Accuracy") == J.bar_svg(labels, vals, "Accuracy")
    assert P.bar_svg(labels, vals, "Loss", unit="") == J.bar_svg(labels, vals, "Loss", unit="")
    svgs = [P.bar_svg(labels, vals, "Accuracy"), P.confusion_svg(cm, names, "t")]
    P.write_html(tmp_path / "ours.html", "Before/After — <Metrics>", svgs)
    J.write_html(tmp_path / "theirs.html", "Before/After — <Metrics>", svgs)
    assert (tmp_path / "ours.html").read_bytes() == (tmp_path / "theirs.html").read_bytes()


@pytest.mark.parametrize("taxonomy", ["folder", "5class"])
def test_encode_labels_equals_the_jax_package(taxonomy):
    from stutter_tpu import data as J
    from stutter_tpu_torch import data as P

    assert P.DYSFLUENCY_CLASSES_5 == J.DYSFLUENCY_CLASSES_5
    assert P.CORPUS_LABEL_TO_5CLASS == J.CORPUS_LABEL_TO_5CLASS
    labels = ["word repetition", "block", "Prolongatio sample", "syllable repetition", "block"]
    assert P.map_labels_to_5class(labels) == J.map_labels_to_5class(labels)
    ours, ole = P.encode_labels(labels, taxonomy)
    theirs, jle = J.encode_labels(labels, taxonomy)
    assert ours == theirs and ole.classes_ == jle.classes_
    np.testing.assert_array_equal(ole.transform(ours), jle.transform(theirs))
    for mod in (P, J):
        with pytest.raises(ValueError, match="taxonomy"):
            mod.encode_labels(["tonal"] if taxonomy == "5class" else labels,
                              "5class" if taxonomy == "5class" else "nope")


def _sk_params(model):
    if hasattr(model, "models"):
        return [type(model).__name__, [_sk_params(m) for m in model.models]]
    return [type(model).__name__, model.get_params()]


@pytest.mark.parametrize("variant", ["main", "pipeline1"])
def test_reference_model_zoo_equals_the_jax_package(variant):
    pytest.importorskip("sklearn")
    from stutter_tpu.models import host_baselines as J
    from stutter_tpu_torch.models import host_baselines as P

    ours, theirs = P.reference_model_zoo(variant, 7), J.reference_model_zoo(variant, 7)
    assert list(ours) == list(theirs)
    assert [_sk_params(m) for m in ours.values()] == [_sk_params(m) for m in theirs.values()]


def test_persist_sklearn_helpers_equal_the_jax_package(tmp_path):
    """The sklearn exports, the pickle trio and the stale-pickle sweep: the
    same files and the same fitted state from either package."""
    pytest.importorskip("joblib")
    import joblib

    from stutter_tpu import persist as J
    from stutter_tpu.models.scaler import LabelEncoder as JLE
    from stutter_tpu.models.scaler import StandardScaler as JSS
    from stutter_tpu_torch import persist as P
    from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler

    X = np.random.RandomState(4).randn(30, 6).astype(np.float32)
    X[:, 2] = 1.0  # a constant column: scale 1, variance 0
    classes = ["block", "fluent", "word repetition"]
    for mod, ss, le, d in ((P, StandardScaler, LabelEncoder, tmp_path / "ours"),
                           (J, JSS, JLE, tmp_path / "theirs")):
        mod.save_sklearn_artifacts(str(d), scaler=ss.fit(X), le=le(classes_=classes), rf=None)
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "theirs")) == [
        "label_encoder.pkl", "scaler_after.pkl"]
    a, b = (joblib.load(tmp_path / d / "scaler_after.pkl") for d in ("ours", "theirs"))
    for attr in ("mean_", "scale_", "var_", "n_features_in_", "n_samples_seen_"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    np.testing.assert_array_equal(a.transform(X), b.transform(X))
    a, b = (joblib.load(tmp_path / d / "label_encoder.pkl") for d in ("ours", "theirs"))
    np.testing.assert_array_equal(a.classes_, b.classes_)
    assert list(a.inverse_transform([2, 0])) == ["word repetition", "block"]
    for mod, d in ((P, tmp_path / "ours"), (J, tmp_path / "theirs")):
        (d / "model_rf.pkl").write_bytes(b"stale")
        (d / "model_mlp_tpu.npz").write_bytes(b"kept")
        mod.clear_stale_artifacts(str(d))
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "theirs")) == [
        "model_mlp_tpu.npz"]


def _vote_inputs(seed, n_members):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 3, 60)
    probas = {f"m{i}": rng.dirichlet(np.ones(3), 60).astype(np.float32) for i in range(n_members)}
    probas["m0"][np.arange(60), y] += 0.3  # one member that knows something
    folds = [(np.setdiff1d(np.arange(60), np.arange(k, 60, 4)), np.arange(k, 60, 4))
             for k in range(4)]
    return probas, y, folds


@pytest.mark.parametrize("n_members", [2, 3])
def test_nested_weighted_vote_and_its_band_equal_the_jax_package(n_members):
    from stutter_tpu.train import ensemble as J
    from stutter_tpu_torch.train import ensemble as P

    probas, y, folds = _vote_inputs(5, n_members)
    for step in (0.05, 0.25):
        ours, theirs = P.nested_weighted_vote(probas, y, folds, step), J.nested_weighted_vote(
            probas, y, folds, step)
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
        assert ours[2] == theirs[2] and len(ours[2]) == 4
    assert P.bootstrap_vote_band(probas, y, folds, 0.25, n_boot=20, seed=3) == \
        J.bootstrap_vote_band(probas, y, folds, 0.25, n_boot=20, seed=3)
    with pytest.raises(ValueError, match="cover"):
        P.nested_weighted_vote(probas, y, folds[:3])


def test_stem_collisions_and_cached_corpus_equal_the_jax_package(tmp_path):
    """find_stem_collisions and load_cached_corpus over one synthetic tree
    whose cache misses an entry: the same dict in both packages."""
    from stutter_tpu import data as J
    from stutter_tpu_torch import data as P

    audio = tmp_path / "segrigated_samples"
    for rel in ("block/a.wav", "fluent/a.wav", "block/b.wav", "fluent/c.mp3"):
        (audio / rel).parent.mkdir(parents=True, exist_ok=True)
        (audio / rel).write_bytes(b"")
    assert P.find_stem_collisions(str(audio)) == J.find_stem_collisions(str(audio)) == {
        "a": ["block", "fluent"]}
    (tmp_path / "cache_features").mkdir()
    rng = np.random.RandomState(6)
    for stem in ("a", "b"):
        np.save(tmp_path / "cache_features" / f"{stem}_clean_feats.npy",
                rng.randn(149).astype(np.float32))
    np.save(tmp_path / "cache_features" / "c_raw_feats.npy", rng.randn(160).astype(np.float32))
    ours = P.load_cached_corpus(P.DataConfig(), str(tmp_path))
    theirs = J.load_cached_corpus(jconfig.DataConfig(), str(tmp_path))
    assert sorted(ours) == sorted(theirs)
    assert ours["missing_raw"] == theirs["missing_raw"] == 3 and ours["missing_clean"] == 1
    for k, v in theirs.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(ours[k], v)
        else:
            assert ours[k] == v, k


def test_seq_training_config_and_recipes_equal_the_jax_package():
    """SeqTrainConfig's fields and defaults, balanced_row_weights, and each
    architecture's recipe and init widths."""
    from stutter_tpu.train import seq_pipeline as JP
    from stutter_tpu.train import seq_trainer as JT
    from stutter_tpu_torch.train import seq_pipeline as P
    from stutter_tpu_torch.train import seq_trainer as T

    assert dataclasses.asdict(T.SeqTrainConfig()) == dataclasses.asdict(JT.SeqTrainConfig())
    y = np.array([0] * 9 + [1] * 3 + [2])
    np.testing.assert_array_equal(T.balanced_row_weights(y, 4), JT.balanced_row_weights(y, 4))
    assert list(P.ARCHS) == list(JP.ARCHS)
    for arch in P.ARCHS:
        assert P.default_train_cfg(arch, 7) == T.SeqTrainConfig(
            **dataclasses.asdict(JP.default_train_cfg(arch, 7)))
        assert P.ARCHS[arch]["kind"] == JP.ARCHS[arch]["kind"]
        assert P.ARCHS[arch]["init_kwargs"](5) == JP.ARCHS[arch]["init_kwargs"](5)


def test_get_or_compute_caches_like_the_jax_package(tmp_path):
    """Computes once, loads on the second call; the .npy bytes equal the
    JAX FeatureCache's for the same path and suffix."""
    from stutter_tpu import cache as jcache
    from stutter_tpu_torch import cache

    audio = "/corpus/segrigated_samples/block/clip_0007.mp3"
    v = np.random.RandomState(8).randn(149)  # float64: stored as float32
    files = {}
    for name, mod in (("ours", cache), ("theirs", jcache)):
        c = mod.FeatureCache(str(tmp_path / name))
        calls = []
        first = c.get_or_compute(audio, "raw", lambda: calls.append(1) or v)
        second = c.get_or_compute(audio, "raw", lambda: calls.append(1) or v + 1)
        assert len(calls) == 1 and first.dtype == np.float32
        np.testing.assert_array_equal(first, v.astype(np.float32))
        np.testing.assert_array_equal(second, first)
        files[name] = (tmp_path / name / os.path.basename(c.path_for(audio, "raw"))).read_bytes()
    assert files["ours"] == files["theirs"]


@pytest.mark.parametrize("warn", [True, False])
def test_collision_warning_gate_equals_the_jax_package(tmp_path, caplog, warn):
    from stutter_tpu import cache as jcache
    from stutter_tpu_torch import cache

    v = np.zeros(149, np.float32)
    for name, mod in (("ours", cache), ("theirs", jcache)):
        c = mod.FeatureCache(str(tmp_path / name), warn_collisions=warn)
        caplog.clear()
        c.store("/c/block/x.wav", "raw", v)
        c.store("/c/fluent/x.wav", "raw", v)
        hits = [r for r in caplog.records if "stem collision" in r.getMessage()]
        assert len(hits) == (1 if warn else 0), name


def test_per_class_auc_equals_the_jax_package():
    from stutter_tpu import evals as J
    from stutter_tpu_torch import evals as P

    rng = np.random.RandomState(9)
    y = rng.randint(0, 4, 300)
    proba = rng.dirichlet(np.ones(4), 300)
    proba[np.arange(300), y] += 0.2 * rng.rand(300)
    ours, theirs = P.per_class_auc(y, proba), J.per_class_auc(y, proba)
    assert len(ours) == len(theirs) == 4
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)


def test_feature_importances_rf_passes_through_like_the_jax_package():
    from stutter_tpu.models import host_baselines as J
    from stutter_tpu_torch.models import host_baselines as P

    class Fitted:
        feature_importances_ = list(np.random.RandomState(10).dirichlet(np.ones(149)))

    ours, theirs = P.feature_importances_rf(Fitted()), J.feature_importances_rf(Fitted())
    assert isinstance(ours, np.ndarray) and ours.shape == (149,)
    np.testing.assert_array_equal(ours, theirs)


def test_scaler_and_label_encoder_inverses_equal_the_jax_package():
    from stutter_tpu.models import scaler as J
    from stutter_tpu_torch.models import scaler as P

    rng = np.random.RandomState(11)
    X = (rng.randn(40, 149) * 3 + 1).astype(np.float32)
    X[:, 5] = 2.0  # a constant column: scale 1
    ours, theirs = P.StandardScaler.fit(X), J.StandardScaler.fit(X)
    Z = ours.transform(X)
    back = ours.inverse_transform(Z)
    np.testing.assert_allclose(back, np.asarray(theirs.inverse_transform(theirs.transform(X))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(back, X, rtol=0, atol=1e-5)
    labels = ["word repetition", "block", "fluent", "block", "prolongation"]
    ole, jle = P.LabelEncoder(classes_=[]), J.LabelEncoder(classes_=[])
    y, jy = ole.fit_transform(labels), jle.fit_transform(labels)
    np.testing.assert_array_equal(y, jy)
    assert ole.classes_ == jle.classes_ and ole.n_classes == jle.n_classes == 4
    assert ole.inverse_transform(y) == jle.inverse_transform(jy) == labels
    assert ole.inverse_transform(2) == jle.inverse_transform(2) == ["prolongation"]


def test_load_mp3_resamples_like_the_jax_package(monkeypatch):
    """Both packages' decode_mp3 patched to the same 22.05 kHz signal:
    load_mp3 at 16 kHz agrees within the resampler's bound (1e-5), and at
    its own rate returns the decode unchanged."""
    from stutter_tpu.io import mp3 as jmp3
    from stutter_tpu_torch.io import mp3

    rng = np.random.RandomState(12)
    t = np.arange(22050 * 2) / 22050
    y = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(t.size)).astype(np.float32)
    for mod in (mp3, jmp3):
        monkeypatch.setattr(mod, "decode_mp3", lambda path: (y, 22050))
    ours, sr = mp3.load_mp3("clip.mp3", 16000, device="cpu")
    theirs, jsr = jmp3.load_mp3("clip.mp3", 16000)
    assert sr == jsr == 16000 and ours.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    for rate in (None, 22050):
        same, native = mp3.load_mp3("clip.mp3", rate, device="cpu")
        assert native == 22050
        np.testing.assert_array_equal(same, y)


def test_native_available_equals_the_jax_package():
    from stutter_tpu.io import native as J
    from stutter_tpu_torch.io import native as P

    assert isinstance(P.native_available(), bool)
    assert P.native_available() == J.native_available()


def test_extract_features_149_numpy_equals_the_jax_package():
    """The JAX name and signature, in input order over two buckets: the MFCC
    block within 2e-3, chroma within 1e-5 (the bounds of
    test_torch_slice.py), the text block zero."""
    import stutter_tpu
    import stutter_tpu_torch

    rng = np.random.RandomState(13)
    t = np.arange(40000) / 16000
    clips = [(0.5 * np.sin(2 * np.pi * 330 * t[:24000]) + 0.03 * rng.randn(24000)),
             0.3 * rng.randn(40000),
             0.4 * np.sin(2 * np.pi * 612.5 * t[:9000]) + 0.05 * rng.randn(9000)]
    clips = [c.astype(np.float32) for c in clips]
    ours = stutter_tpu_torch.extract_features_149_numpy(clips, 16000, batch_size=2, device="cpu")
    theirs = stutter_tpu.extract_features_149_numpy(clips, 16000, batch_size=2)
    assert ours.shape == theirs.shape == (3, 149)
    assert np.abs(ours[:, :120] - theirs[:, :120]).max() < 2e-3
    assert np.abs(ours[:, 120:144] - theirs[:, 120:144]).max() < 1e-5
    assert (ours[:, 144:] == 0).all()
