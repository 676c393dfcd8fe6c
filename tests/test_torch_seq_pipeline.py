"""The port's sequence-head driver (train/seq_pipeline.py), run_cv's
sequence heads and the CLI's train --seq / train-seq against the JAX
package on the CPU.

The heads run at small widths (each package's ARCHS given small init
widths: CNN channels (4,), CNN-BiLSTM conv 8 / LSTM 8, transformer
d_model 16 with one block) and few epochs, on the tones-vs-noise workspace
of tests/test_torch_train_pipeline.py.  Where only the assembly is under
test, both packages' trainers are replaced by the same fixed weights, as
tests/test_models.py does.  Every test seeds its own numpy generator."""

import csv
import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stutter_tpu import config as jconfig
from stutter_tpu.train import seq_pipeline as JP
from stutter_tpu.train import seq_trainer as JT
from stutter_tpu_torch.config import PipelineConfig
from stutter_tpu_torch.io.wav import write_wav
from stutter_tpu_torch.train import seq_pipeline as P
from stutter_tpu_torch.train import seq_trainer as T

torch.set_num_threads(2)

CFG, JCFG = PipelineConfig(), jconfig.PipelineConfig()
SMALL = {"cnn": {"channels": (4,)}, "cnn_bilstm": {"conv_channels": (8,), "lstm_dim": 8},
         "transformer": {"d_model": 16, "n_blocks": 1, "d_ff": 16}}


def _shrink_archs(mp, *pkgs):
    """Each package's ARCHS at the small widths."""
    for pkg in pkgs:
        for arch, spec in list(pkg.ARCHS.items()):
            orig = spec["init_kwargs"]
            small = SMALL["transformer" if arch.startswith("transformer") else arch]
            mp.setitem(pkg.ARCHS, arch,
                       {**spec, "init_kwargs": lambda c, o=orig, s=small: {**o(c), **s}})


def _write_corpus(root):
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


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The tones-vs-noise workspace, preprocessed and extracted by the port."""
    from stutter_tpu_torch import pipeline

    root = tmp_path_factory.mktemp("seqbase")
    _write_corpus(root)
    pipeline.preprocess(str(root), CFG, device="cpu")
    for sfx in ("raw", "clean"):
        pipeline.extract_corpus(str(root), CFG, sfx, device="cpu")
    return root


def _copy(src, dst):
    for d in ("segrigated_samples", "clear_audio", "cache_features"):
        shutil.copytree(src / d, dst / d)
    return dst


def _shrink_mlp(mp, pkg):
    orig = pkg.MLPTrainConfig
    mp.setattr(pkg, "MLPTrainConfig", lambda **kw: orig(epochs=30, n_seeds=2, **kw))


def _fixed_params(arch, n, D, C, seed):
    """n JAX-initialized weight sets of `arch` at small widths."""
    kw = {**JP.ARCHS[arch]["init_kwargs"](C),
          **({"n_mels": D} if arch != "cnn_bilstm" else {"in_dim": D}), **SMALL[arch]}
    return [{k: np.asarray(v) for k, v in
             JP.ARCHS[arch]["init_fn"](jax.random.PRNGKey(seed + i), **kw).items()}
            for i in range(n)]


@pytest.mark.parametrize("arch", ["cnn", "cnn_bilstm", "transformer"])
def test_cross_validate_seq_equals_jax_on_fixed_weights(monkeypatch, arch):
    """Both trainers replaced by the same fixed weights (per grid entry, in
    grid order), the same frames: y_proba and each TTA view within 1e-5
    of the JAX package's; class_balanced hands both trainers the same
    [G, N] weights; the port's chunks of 2 cover G = 4 = 2 folds x 2 seeds
    (the JAX package's chunk also scales with its device count)."""
    rng = np.random.RandomState(1)
    n, n_t, D, C = 16, 20, 12, 3
    X = rng.randn(n, n_t, D).astype(np.float32) * 3 + 1
    nv = rng.randint(4, n_t + 1, n).astype(np.int32)
    X *= (np.arange(n_t)[None] < nv[:, None])[..., None]
    y = np.arange(n) % C
    folds = [(np.arange(8, 16), np.arange(8)), (np.arange(8), np.arange(8, 16))]
    fixed = _fixed_params(arch, 4, D, C, 30)
    seen = {"jax": [], "torch": []}

    def entries(who, w):
        g0 = sum(len(v) for v in seen[who])
        seen[who].append(np.asarray(w))
        return fixed[g0 : g0 + len(w)]

    def jax_grid(*a, **k):
        ps = entries("jax", a[3])
        return {key: jnp.stack([p[key] for p in ps]) for key in ps[0]}

    def port_grid(X_, nv_, y_, w, *a, module, device, **k):
        return T.SeqGrid(module, entries("torch", w), device)

    monkeypatch.setattr(JT, "train_seq_grid", jax_grid)
    monkeypatch.setattr(T, "train_seq_grid", port_grid)
    monkeypatch.setattr(JP, "prepare_sequence_dataset", lambda c, kind: (X, nv))
    monkeypatch.setattr(P, "prepare_sequence_dataset", lambda c, kind, device: (X, nv))
    clips = [np.zeros(100, np.float32)] * n
    cfg = dict(epochs=1, batch_size=4, class_balanced=True)
    vp, jvp = [], []
    _, proba = P.cross_validate_seq(arch, clips, y, folds, C, T.SeqTrainConfig(**cfg),
                                    n_seeds=2, grid_chunk=2, tta_crops=(3,), view_probas=vp,
                                    device="cpu")
    _, jproba = JP.cross_validate_seq(arch, clips, y, folds, C, JT.SeqTrainConfig(**cfg),
                                      n_seeds=2, grid_chunk=2, tta_crops=(3,), view_probas=jvp)
    assert len(seen["torch"]) == 2 and len(vp) == len(jvp) == 3
    w = np.concatenate(seen["torch"])
    np.testing.assert_array_equal(w, np.concatenate(seen["jax"]))
    assert w.shape == (4, n) and w[0, 8:].std() > 0  # balanced weights, not membership
    np.testing.assert_allclose(proba, jproba, rtol=0, atol=1e-5)
    for a, b in zip(vp, jvp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert np.abs(vp[0] - vp[1]).max() > 1e-3  # the cropped views differ


@pytest.mark.parametrize("arch", ["cnn", "cnn_bilstm", "transformer"])
def test_grid_chunk_1_equals_chunk_G_exactly(monkeypatch, arch):
    """cross_validate_seq trained for real, its grid of 3 folds x 2 seeds in
    chunks of 1 and in one chunk of 6: the same probabilities, exactly."""
    rng = np.random.RandomState(2)
    n, n_t, D, C = 18, 16, 128 if arch != "cnn_bilstm" else 60, 2
    X = rng.randn(n, n_t, D).astype(np.float32)
    y = np.arange(n) % C
    X += y[:, None, None] * 0.5
    nv = rng.randint(5, n_t + 1, n).astype(np.int32)
    monkeypatch.setattr(P, "prepare_sequence_dataset", lambda c, kind, device: (X, nv))
    _shrink_archs(monkeypatch, P)
    folds = [(np.setdiff1d(np.arange(n), np.arange(k, n, 3)), np.arange(k, n, 3))
             for k in range(3)]
    tc = T.SeqTrainConfig(epochs=3, batch_size=4, mixup_alpha=0.2, time_masks=1,
                          time_width=3, freq_masks=1, freq_width=4)
    out = [P.cross_validate_seq(arch, [None] * n, y, folds, C, tc, n_seeds=2, grid_chunk=g,
                                device="cpu")[1] for g in (1, 6)]
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_allclose(out[0].sum(-1), 1.0, atol=1e-5)


# the files run_cv(include_seq=True) adds on a corpus, beside engine B's
SEQ_FILES = {"oof_probas.npz", "ensemble_weights.json", "ensemble.json"} | {
    f"model_{a}{s}" for a in P.ARCHS for s in (".npz", ".json", "_norm.npz")}


@pytest.fixture(scope="module")
def seq_runs(base, tmp_path_factory):
    """run_cv(include_host=False, include_seq=True): the port's trained for
    real (2 epochs, small widths); the JAX package's with its
    cross_validate_seq and fit_seq_head replaced by fixed outputs (its file
    set, names and headers are what is compared)."""
    from stutter_tpu import pipeline as J
    from stutter_tpu_torch import pipeline as TP

    roots = {w: _copy(base, tmp_path_factory.mktemp(f"seq_{w}")) for w in ("torch", "jax")}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (J, TP):
            _shrink_mlp(mp, pkg)
        _shrink_archs(mp, P, JP)
        n_rows = {}

        def fake_cv(arch, clips, y, folds, n_classes, *a, **k):
            rng = np.random.RandomState(len(arch))
            p = rng.dirichlet(np.ones(n_classes), len(y)).astype(np.float32)
            p[np.arange(len(y)), y] += 2.0
            p /= p.sum(-1, keepdims=True)
            n_rows[arch] = len(y)
            return p.argmax(-1), p

        def fake_fit(arch, clips, y, n_classes, tc):
            spec = JP.ARCHS[arch]
            params = spec["init_fn"](jax.random.PRNGKey(0), **spec["init_kwargs"](n_classes))
            D = 60 if spec["kind"] == "mfcc_deltas" else 128
            return params, np.zeros(D, np.float32), np.ones(D, np.float32)

        mp.setattr(JP, "cross_validate_seq", fake_cv)
        mp.setattr(JP, "fit_seq_head", fake_fit)
        out["torch"] = TP.run_cv(str(roots["torch"]), CFG, include_host=False, include_seq=True,
                                 seq_epochs=2, device="cpu")
        out["jax"] = J.run_cv(str(roots["jax"]), JCFG, include_host=False, include_seq=True,
                              seq_epochs=2)
    return {"roots": roots, "out": out}


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


def test_run_cv_seq_writes_the_jax_packages_files(seq_runs):
    """The same files, CSV headers, row names, npz keys and JSON keys; the
    members' metadata byte for byte; each member's weights in the JAX
    package's names and shapes; the vote's weights a distribution."""
    t, j = (seq_runs["roots"][w] / "output_results" for w in ("torch", "jax"))
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))
    assert SEQ_FILES <= set(os.listdir(t))
    for name in os.listdir(t):
        if name.endswith(".csv"):
            assert _header(t / name) == _header(j / name), name
        elif name.endswith(".npz"):
            with np.load(t / name) as a, np.load(j / name) as b:
                assert sorted(a) == sorted(b), name
                if name.startswith("model_") and "mlp" not in name:
                    assert all(a[k].shape == b[k].shape for k in a), name
        elif name.endswith(".json") and name.startswith("model_") and "mlp" not in name:
            assert (t / name).read_text() == (j / name).read_text(), name
    rows = [r["Model"] for r in seq_runs["out"]["torch"]["final_rows"]]
    assert rows == [r["Model"] for r in seq_runs["out"]["jax"]["final_rows"]]
    assert rows == ["MLP-TPU"] + [f"{a.upper()}-TPU" for a in P.ARCHS] + ["Weighted-Vote-TPU"]
    ens, jens = (json.loads((d / "ensemble.json").read_text()) for d in (t, j))
    assert sorted(ens) == sorted(jens) == ["classes", "weights"]
    assert sorted(ens["weights"]) == sorted(jens["weights"]) == sorted(P.ARCHS)
    assert abs(sum(ens["weights"].values()) - 1) < 1e-9 and ens["classes"] == jens["classes"]
    folds_w = json.loads((t / "ensemble_weights.json").read_text())
    assert len(folds_w) == 5 and all(sorted(w) == sorted(P.ARCHS) for w in folds_w)
    with np.load(t / "oof_probas.npz") as z:
        assert z["fold_of"].shape == z["y"].shape == (20,) and sorted(set(z["fold_of"])) == [
            0, 1, 2, 3, 4]
        assert all(z[f"proba_{a}"].shape == (20, 2) for a in P.ARCHS)


def test_run_cv_seq_reports_each_stage_and_learns(seq_runs):
    """stage_s holds the sequence stages (each arch's CV grid and refit,
    the vote); tones vs noise: the MLP and the vote near the top."""
    out = seq_runs["out"]["torch"]
    want = {"seq_clips", "seq_vote"} | {f"seq_{s}_{a}" for a in P.ARCHS for s in ("cv", "fit")}
    assert want <= set(out["stage_s"]) and all(v > 0 for v in out["stage_s"].values())
    acc = {r["Model"]: r["Accuracy (%)"] for r in out["final_rows"]}
    assert acc["MLP-TPU"] >= 90 and acc["Weighted-Vote-TPU"] >= 90


def test_jax_ensemble_predictor_serves_the_ports_artifacts(seq_runs, base):
    """EnsemblePredictor.load in both packages on the port's run_cv
    artifacts: the same label and probabilities within 1e-4 per clip."""
    from stutter_tpu.infer import EnsemblePredictor as JEns
    from stutter_tpu_torch.infer import EnsemblePredictor

    out_dir = str(seq_runs["roots"]["torch"] / "output_results")
    ours = EnsemblePredictor.load(out_dir, device="cpu")
    theirs = JEns.load(out_dir)
    assert sorted(ours.weights) == sorted(theirs.weights)
    rng = np.random.RandomState(3)
    t = np.arange(20000) / 16000
    for y in (0.5 * np.sin(2 * np.pi * 440 * t), rng.randn(12000) * 0.2):
        y = y.astype(np.float32)
        a, b = ours.predict_clip(y, denoise=False), theirs.predict_clip(y, denoise=False)
        assert a["label"] == b["label"]
        assert max(abs(a["proba"][c] - b["proba"][c]) for c in a["proba"]) < 1e-4


KNOBS = {"include_seq": ({}, ["CNN-TPU", "CNN_BILSTM-TPU", "TRANSFORMER-TPU",
                              "TRANSFORMER_LR1E3-TPU", "TRANSFORMER_MIX4_LR1E3-TPU"]),
         "seq_seeds": ({"seq_seeds": 5}, ["CNN-TPU"]),
         "ensemble_mlp": ({"ensemble_mlp": "both"}, ["CNN-TPU"]),
         "seq_tta_crops": ({"seq_tta_crops": (40,)}, ["CNN-TPU+TTA", "CNN-TPU"]),
         "seq_raw_archs": ({"seq_raw_archs": ("cnn",)}, ["CNN-TPU", "CNN-RAW-TPU"]),
         "seq_class_balanced": ({"seq_class_balanced": True}, ["CNN-TPU"])}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_run_cv_runs_each_sequence_knob(base, tmp_path, monkeypatch, knob):
    """Each of the six sequence knobs runs its path on the tiny corpus and
    writes its rows and files (the quint for include_seq, the cnn alone
    for the others): ensemble_mlp's member and its artifacts, the +TTA
    rows, the raw probe's row and ensemble_probe.json, G = 25 for 5 seeds,
    balanced sampling for the CV grid and the refit."""
    from stutter_tpu_torch import pipeline as TP

    root = _copy(base, tmp_path / "ws")
    _shrink_mlp(monkeypatch, TP)
    _shrink_archs(monkeypatch, P)
    grids, cfgs = [], []
    orig, orig_fit = T.train_seq_grid, P.train_sequence_model
    monkeypatch.setattr(T, "train_seq_grid", lambda *a, **k: grids.append(np.asarray(a[3]))
                        or cfgs.append(k["cfg"]) or orig(*a, **k))
    monkeypatch.setattr(P, "train_sequence_model",
                        lambda *a, **k: cfgs.append(a[6]) or orig_fit(*a, **k))
    kw, seq_rows = KNOBS[knob]
    if knob != "include_seq":
        kw = {**kw, "seq_archs": ("cnn",)}
    res = TP.run_cv(str(root), CFG, include_host=False, include_seq=True, seq_epochs=1,
                    device="cpu", **kw)
    rows = [r["Model"] for r in res["final_rows"]]
    vote = ["Weighted-Vote-TPU"] + (["Weighted-Vote-TPU+TTA"] if knob == "seq_tta_crops" else [])
    assert rows == ["MLP-TPU"] + seq_rows + vote
    out = root / "output_results"
    weights = json.loads((out / "ensemble.json").read_text())["weights"]
    n_grid = sum(len(w) for w in grids) // (2 if knob == "seq_raw_archs" else 1)
    assert n_grid == (25 if knob == "seq_seeds" else 5) * (5 if knob == "include_seq" else 1)
    if knob == "ensemble_mlp":
        assert sorted(weights) == ["cnn", "mlp_both"]
        assert {"model_mlp_both_tpu.npz", "model_mlp_both_tpu.json",
                "scaler_both.npz"} <= set(os.listdir(out))
    elif knob == "seq_raw_archs":
        probe = json.loads((out / "ensemble_probe.json").read_text())["weights"]
        servable = {k: (0.0 if k.endswith("_raw") else v) for k, v in probe.items()}
        total = sum(servable.values()) or 1.0
        assert sorted(probe) == ["cnn", "cnn_raw"] and weights["cnn_raw"] == 0.0
        assert weights == {k: v / total for k, v in servable.items()}
        assert "model_cnn_raw.npz" not in os.listdir(out)
    elif knob == "seq_class_balanced":
        assert len(cfgs) == 2 and all(c.class_balanced for c in cfgs)  # the grid, the refit
    else:
        assert "ensemble_probe.json" not in os.listdir(out)


def test_run_seq_standardizes_over_all_clips(base, tmp_path, monkeypatch):
    """run_seq, as the JAX package's: the persisted stats standardize ALL
    clips' frames, the test split's included, before the 80/20 split (only
    feature statistics leak, no labels); it trains on the split's 16 rows,
    writes the head's artifacts and confusion_<arch>.csv, and with ckpt
    its checkpoints."""
    root = _copy(base, tmp_path / "ws")
    _shrink_archs(monkeypatch, P)
    res = P.run_seq(str(root), "cnn", CFG, T.SeqTrainConfig(epochs=2, batch_size=8), ckpt=True,
                    device="cpu")
    out = root / "output_results"
    clips, _ = P.load_corpus_clips(str(root), CFG, device="cpu")
    X, nv = P.prepare_sequence_dataset(clips, "logmel", device="cpu")
    _, mean, std = T.standardize_sequences(X, nv)
    with np.load(out / "model_cnn_norm.npz") as z:
        np.testing.assert_array_equal(z["mean"], mean)
        np.testing.assert_array_equal(z["std"], std)
    tr, _ = P.stratified_train_test_split(np.arange(20) % 2, 0.2, 42)
    _, mean_tr, _ = T.standardize_sequences(X[tr], nv[tr])
    assert np.abs(mean - mean_tr).max() > 1e-3  # the split's own stats differ
    assert res["arch"] == "cnn" and res["classes"] == ["noisy", "tonal"]
    assert 0 <= res["accuracy"] <= 100 and np.isfinite(res["test_loss"])
    assert {"model_cnn.npz", "model_cnn.json", "confusion_cnn.csv"} <= set(os.listdir(out))
    assert sorted(os.listdir(out / "ckpt_cnn")) == ["step_4.pt"]  # 2 epochs of 16 // 8 steps


def _flags(main, cmd):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main([cmd, "--help"])
    return set(re.findall(r"(--[a-z][a-z-]*)", buf.getvalue())) - {"--help"}


def test_cli_train_seq_and_train_seq_print_the_jax_clis_lines(base, tmp_path, monkeypatch,
                                                              capsys):
    """train --seq --no-host and train-seq --ckpt on the CPU (small widths,
    2 epochs) print the JAX CLI's lines; both subcommands take the JAX
    CLI's flags, and --device."""
    from stutter_tpu import cli as jcli
    from stutter_tpu_torch import cli
    from stutter_tpu_torch import pipeline as TP

    for cmd in ("train", "train-seq"):
        assert _flags(cli.main, cmd) == _flags(jcli.main, cmd) | {"--device"}, cmd
    capsys.readouterr()
    root = _copy(base, tmp_path / "ws")
    _shrink_mlp(monkeypatch, TP)
    _shrink_archs(monkeypatch, P)
    recipe = P.default_train_cfg
    monkeypatch.setattr(P, "default_train_cfg", lambda arch, epochs=80: recipe(arch, 2))
    assert cli.main(["train", "--root", str(root), "--no-host", "--seq", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    names = ["MLP-TPU"] + [f"{a.upper()}-TPU" for a in P.ARCHS] + ["Weighted-Vote-TPU"]
    assert [l.split(" acc=")[0].strip() for l in lines] == names
    assert all(re.fullmatch(r"\S+ +acc=\d+\.\d% P=\d+\.\d R=\d+\.\d F1=\d+\.\d", l)
               for l in lines), lines
    assert cli.main(["train-seq", "--root", str(root), "--arch", "cnn", "--epochs", "2",
                     "--ckpt", "--mixup", "0.3", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r"cnn: acc=\d+\.\d% loss=\d+\.\d{3} \[\d+s\]", line), line
    assert os.listdir(root / "output_results" / "ckpt_cnn") == ["step_2.pt"]  # batch 64: 1 a epoch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            cli.main(["train-seq", "--root", str(tmp_path / "empty")])
        assert not (tmp_path / "empty").exists()


def test_find_stem_collisions_on_a_synthetic_tree(tmp_path):
    """Stems under more than one class folder, with their classes sorted;
    a stem repeated within one folder tree (another extension) is not one."""
    from stutter_tpu_torch.data import find_stem_collisions

    for rel in ("block/a.wav", "fluent/a.mp3", "block/b.wav", "block/sub/b.wav",
                "repetition/c.wav", "fluent/c.wav", "repetition/a.ogg", "fluent/d.txt",
                "block/d.wav"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    assert find_stem_collisions(str(tmp_path)) == {
        "a": ["block", "fluent", "repetition"], "b": ["block", "sub"],
        "c": ["fluent", "repetition"]}
    assert find_stem_collisions(str(tmp_path / "block" / "sub")) == {}
