"""The port's serving slice as a whole against the JAX package: the same
artifacts (written by stutter_tpu.persist), the same clips, denoise on."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
HIDDEN = (32, 16)
CLASSES = ["noisy", "tonal", "zzz"]


def _params(seed, n_seeds=3, dims=(149, *HIDDEN, 3)):
    rng = np.random.RandomState(seed)
    p = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"w{i}"] = (rng.randn(n_seeds, a, b) * np.sqrt(2.0 / a)).astype(np.float32)
        p[f"b{i}"] = (rng.randn(n_seeds, b) * 0.1).astype(np.float32)
    return p


def _clips():
    rng = np.random.RandomState(21)
    t = np.arange(24000) / 16000
    return [
        (0.5 * np.sin(2 * np.pi * 330.0 * t) + 0.03 * rng.randn(24000)).astype(np.float32),
        (0.3 * rng.randn(20000)).astype(np.float32),
        (0.4 * np.sin(2 * np.pi * 612.5 * t[:16000]) * (t[:16000] % 0.4 < 0.25)
         + 0.05 * rng.randn(16000)).astype(np.float32),
    ]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """WORK/output_results with JAX-format artifacts: a numpy-seeded MLP and a
    scaler fitted on features of seeded clips."""
    from stutter_tpu import persist
    from stutter_tpu.models.scaler import LabelEncoder, StandardScaler
    from stutter_tpu.train.trainer import FittedMLP, MLPTrainConfig
    from stutter_tpu_torch.config import PipelineConfig
    from stutter_tpu_torch.ops.frontend import extract_features_numpy

    root = tmp_path_factory.mktemp("work")
    out = root / PipelineConfig().data.output_dir
    out.mkdir()
    rng = np.random.RandomState(22)
    fit_clips = [(rng.randn(rng.randint(12000, 24000)) * s).astype(np.float32)
                 for s in (0.05, 0.1, 0.2, 0.4)]
    feats = extract_features_numpy(_clips() + fit_clips, PipelineConfig().features, device="cpu")
    params = _params(23)
    fitted = FittedMLP(params=params, n_seeds=3,
                       cfg=MLPTrainConfig(hidden=HIDDEN, n_classes=3))
    persist.save_mlp(out / "model_mlp_tpu", fitted)
    persist.save_scaler(out / "scaler_after.npz", StandardScaler.fit(feats))
    persist.save_label_encoder(out / "label_encoder.json", LabelEncoder(classes_=CLASSES))
    return root, out, params


def test_from_jax_params_matches_jax_forward():
    import jax.numpy as jnp

    from stutter_tpu.train.trainer import predict_proba_grid
    from stutter_tpu_torch.models.mlp import SeedMLP

    params = _params(24, n_seeds=4)
    x = np.random.RandomState(25).randn(5, 149).astype(np.float32)
    ref = np.asarray(predict_proba_grid({k: jnp.asarray(v) for k, v in params.items()},
                                        jnp.broadcast_to(jnp.asarray(x), (4, 5, 149)))).mean(0)
    model = SeedMLP.from_jax_params(params, device="cpu")
    assert model.n_seeds == 4
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    for k, v in model.to_jax_params().items():
        np.testing.assert_array_equal(v, params[k])
    with pytest.raises(ValueError):
        SeedMLP.from_jax_params({"w0": params["w0"]}, device="cpu")


def test_slice_matches_jax_predictor(workspace):
    """Features (MFCC block 2e-3, chroma block 1e-5), probabilities (1e-4)
    and labels of the port's Predictor on the CPU == the JAX Predictor."""
    from stutter_tpu import config as jconfig
    from stutter_tpu.denoise import denoise_clips as j_denoise
    from stutter_tpu.infer import Predictor as JPredictor
    from stutter_tpu.ops.frontend import extract_features_numpy as j_extract
    from stutter_tpu_torch.config import PipelineConfig
    from stutter_tpu_torch.denoise import denoise_clips
    from stutter_tpu_torch.infer import Predictor
    from stutter_tpu_torch.ops.frontend import extract_features_numpy

    _, out, _ = workspace
    cfg, jcfg = PipelineConfig(), jconfig.PipelineConfig()
    clips = _clips()
    ours = extract_features_numpy(denoise_clips(clips, cfg.denoise, device="cpu"), cfg.features,
                                  device="cpu")
    theirs = j_extract(j_denoise(clips, jcfg.denoise), jcfg.features)
    assert ours.shape == theirs.shape == (3, 149)
    assert np.abs(ours[:, :120] - theirs[:, :120]).max() < 2e-3
    assert np.abs(ours[:, 120:144] - theirs[:, 120:144]).max() < 1e-5
    assert (ours[:, 144:] == 0).all()

    jp = JPredictor.load(str(out), jcfg)
    tp = Predictor.load(str(out), cfg, device="cpu")
    assert tp.denoise_first and jp.denoise_first
    for y in clips:
        r, rj = tp.predict_clip(y), jp.predict_clip(y)
        assert r["label"] == rj["label"]
        assert set(r["proba"]) == set(CLASSES)
        assert abs(sum(r["proba"].values()) - 1) < 1e-5
        for c in CLASSES:
            assert abs(r["proba"][c] - rj["proba"][c]) < 1e-4


def test_predict_file_resamples_and_shape_guard(workspace, tmp_path):
    from stutter_tpu_torch.infer import Predictor
    from stutter_tpu_torch.io.wav import write_wav
    from stutter_tpu_torch.models.scaler import StandardScaler
    from stutter_tpu_torch.ops.resample import resample

    _, out, _ = workspace
    tp = Predictor.load(str(out), device="cpu")
    y = _clips()[0][:16000]
    y22 = resample(y, 16000, 22050, device="cpu")
    wav = tmp_path / "c22.wav"
    write_wav(wav, y22, 22050, subtype="FLOAT")
    r_file = tp.predict_file(str(wav))
    r_clip = tp.predict_clip(y22, sr=22050)
    assert r_file == r_clip

    bad = Predictor(scaler=StandardScaler.fit(np.ones((4, 99), np.float32)),
                    label_encoder=tp.label_encoder, model=tp.model, device=tp.device)
    with pytest.raises(ValueError, match="feature length"):
        bad.predict_clip(y)


def test_cli_predict_on_cpu(workspace, tmp_path, capsys):
    from stutter_tpu_torch import cli
    from stutter_tpu_torch.io.wav import write_wav

    root, _, _ = workspace
    wav = tmp_path / "c16.wav"
    write_wav(wav, _clips()[1], 16000)
    assert cli.main(["predict", str(wav), "--root", str(root), "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["label"] in CLASSES
    assert abs(sum(res["proba"].values()) - 1) < 1e-5


def test_cuda_device_raises_without_gpu(workspace, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    from stutter_tpu_torch import cli
    from stutter_tpu_torch.infer import Predictor, resolve_device

    root, out, _ = workspace
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Predictor.load(str(out), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["predict", str(tmp_path / "none.wav"), "--root", str(root)])
    for cmd in (["preprocess"], ["extract", "--variant", "334"]):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            cli.main([*cmd, "--root", str(tmp_path / "ws")])
    assert not (tmp_path / "ws").exists()  # raised before writing anything


def test_port_never_imports_jax():
    """Importing every module of the port, the corpus path's among them,
    pulls in no JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import stutter_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')\n"
        "         if not m.name.endswith('__main__')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 22, names\n"
        "need = {'pipeline', 'ops.frontend334', 'ops.qc', 'io.native', 'io.decode', 'cli'}\n"
        "assert {'stutter_tpu_torch.' + n for n in need} <= set(names), names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
