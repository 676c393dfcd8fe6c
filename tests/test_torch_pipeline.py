"""The port's corpus path (stutter_tpu_torch.pipeline: preprocess and
extract_corpus, both variants), its decode hooks and its CLI against the
JAX package on a small WAV corpus, on the CPU.

The corpus has three class folders: 16 kHz clips, one 22.05 kHz clip (both
packages resample it), one .ogg file that only a registered decoder hook
reads, and one undecodable file."""

import csv
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from stutter_tpu import config as jconfig
from stutter_tpu.io import decode as jdecode
from stutter_tpu_torch.config import FEATURES_334, DenoiseConfig, PipelineConfig
from stutter_tpu_torch.io.decode import register_decoder, unregister_decoder
from stutter_tpu_torch.io.wav import read_wav, write_wav

torch.set_num_threads(2)

SR = 16000
CFG = PipelineConfig(denoise=DenoiseConfig(prop_decrease=0.8))  # the main.py protocol
CFGS = {149: CFG, 286: PipelineConfig(features=FEATURES_334, denoise=CFG.denoise)}
# the same configurations as the JAX package's own objects, field for field
JCFG = jconfig.PipelineConfig(denoise=jconfig.DenoiseConfig(prop_decrease=0.8))
JCFGS = {149: JCFG, 286: jconfig.PipelineConfig(features=jconfig.FEATURES_334,
                                                 denoise=JCFG.denoise)}
HIDDEN = (32, 16)
CLASSES = ["a", "b", "c"]


def hooked_decoder(path, sr):
    """Stands in for a codec: a tone over a noise floor, both fixed by the
    file name (decoded recordings are never digital silence between
    partials, so every spectral-contrast band has a valley above f32
    rounding)."""
    seed = sum(map(ord, os.path.basename(path)))
    t = np.arange(12000) / sr
    noise = np.random.RandomState(seed).randn(12000)
    return (0.3 * np.sin(2 * np.pi * (300.0 + 10 * (seed % 50)) * t)
            + 0.01 * noise).astype(np.float32)


def _write_corpus(root: Path) -> None:
    rng = np.random.RandomState(41)
    d = {c: root / "segrigated_samples" / c for c in CLASSES}
    for p in d.values():
        p.mkdir(parents=True)
    t = np.arange(24000) / SR
    write_wav(d["a"] / "tone_0.wav", (0.5 * np.sin(2 * np.pi * 330 * t[:20000])
                                      + 0.03 * rng.randn(20000)).astype(np.float32), SR)
    write_wav(d["a"] / "tone_1.wav", (0.4 * np.sin(2 * np.pi * 612.5 * t[:11000])
                                      * (t[:11000] % 0.3 < 0.2)
                                      + 0.05 * rng.randn(11000)).astype(np.float32), SR)
    write_wav(d["b"] / "noise_0.wav", (0.2 * rng.randn(14000)).astype(np.float32), SR)
    (d["b"] / "broken.wav").write_bytes(b"RIFF....not a wave file")
    t22 = np.arange(26000) / 22050
    write_wav(d["c"] / "burst_22k.wav", (0.4 * np.sin(2 * np.pi * 440 * t22) * (t22 % 0.25 < 0.15)
                                         + 0.05 * rng.randn(26000)).astype(np.float32), 22050)
    (d["c"] / "hooked.ogg").write_bytes(b"OggS not really vorbis")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same corpus through the JAX package and through the port (CPU),
    each in its own workspace, with the .ogg hook registered.  The JAX
    package extracts the clean rows from a copy of the port's clear_audio/,
    so both extractors read the same clean audio."""
    from stutter_tpu import pipeline as J
    from stutter_tpu_torch import pipeline as P

    base = tmp_path_factory.mktemp("corpus")
    _write_corpus(base)
    roots = {}
    for who in ("jax", "torch", "jax_clean"):
        roots[who] = tmp_path_factory.mktemp(who)
        shutil.copytree(base / "segrigated_samples", roots[who] / "segrigated_samples")
    out = {"roots": roots}
    register_decoder(".ogg", hooked_decoder)  # each package has its own registry
    jdecode.register_decoder(".ogg", hooked_decoder)
    try:
        out["jax_rows"] = J.preprocess(str(roots["jax"]), JCFG)
        out["torch_rows"] = P.preprocess(str(roots["torch"]), CFG, device="cpu")
        shutil.copytree(roots["torch"] / "clear_audio", roots["jax_clean"] / "clear_audio")
        for dim, cfg in CFGS.items():
            for sfx in ("raw", "clean"):
                out["jax", dim, sfx] = J.extract_corpus(
                    str(roots["jax" if sfx == "raw" else "jax_clean"]), JCFGS[dim], sfx)
                out["torch", dim, sfx] = P.extract_corpus(str(roots["torch"]), cfg, sfx,
                                                          device="cpu")
    finally:
        unregister_decoder(".ogg")
        jdecode.unregister_decoder(".ogg")
    return out


def _csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_preprocess_matches_jax(runs):
    """Rows, labels, durations and CSV columns equal; QC values within the
    bounds of tests/test_torch_frontend334.py (SNR 1e-3 dB, flatness and hf
    ratio 1e-5); clear_audio holds the same files, whose 16-bit samples
    differ by at most 2 LSB (the gates agree to 5e-5 before peak
    normalisation and quantisation)."""
    roots = runs["roots"]
    jr, tr = runs["jax_rows"], runs["torch_rows"]
    assert len(tr) == len(jr) == 5  # broken.wav is skipped
    assert [r["file"] for r in tr] == [r["file"] for r in jr]
    assert "hooked.ogg" in [r["file"] for r in tr] and "burst_22k.wav" in [r["file"] for r in tr]
    for a, b in zip(tr, jr):
        assert a["label"] == b["label"] and a["duration_sec"] == b["duration_sec"]
        assert a["transcript"] == b["transcript"] == ""
        for k, tol in (("snr", 1e-3), ("spectral_flatness", 1e-5), ("hf_energy_ratio", 1e-5)):
            for when in ("before", "after"):
                key = f"{k}_{when}_db" if k == "snr" else f"{k}_{when}"
                assert abs(float(a[key]) - float(b[key])) < tol, (a["file"], key)

    jh, jv = _csv(roots["jax"] / "output_results" / "per_file_analysis.csv")
    th, tv = _csv(roots["torch"] / "output_results" / "per_file_analysis.csv")
    assert th == jh and len(tv) == len(jv)
    for a, b in zip(tv, jv):
        assert a[:2] == b[:2] and a[-1] == b[-1]
        np.testing.assert_allclose(np.float64(a[2:-1]), np.float64(b[2:-1]), rtol=0, atol=1e-3)

    jc = sorted(os.listdir(roots["jax"] / "clear_audio"))
    assert sorted(os.listdir(roots["torch"] / "clear_audio")) == jc and len(jc) == 5
    for name in jc:
        y_t, sr_t = read_wav(roots["torch"] / "clear_audio" / name)
        y_j, sr_j = read_wav(roots["jax"] / "clear_audio" / name)
        assert sr_t == sr_j == SR and y_t.shape == y_j.shape
        assert np.abs(y_t - y_j).max() <= 2 / 32768, name


@pytest.mark.parametrize("dim", [149, 286])
@pytest.mark.parametrize("sfx", ["raw", "clean"])
def test_extract_corpus_matches_jax(runs, dim, sfx):
    """Labels, files, ok and cache file names equal; features within the
    slice bounds: 149 -- MFCC block 2e-3, chroma block 1e-5; 286 -- dims
    [:264] 1e-3 + 2e-6 relative, contrast 1e-3 dB per band, scalars 1e-3 +
    1e-6 relative."""
    X, labels, files, ok = runs["torch", dim, sfx]
    Xj, labels_j, files_j, ok_j = runs["jax", dim, sfx]
    roots = runs["roots"]
    assert labels == labels_j and [os.path.basename(f) for f in files] == [
        os.path.basename(f) for f in files_j]
    np.testing.assert_array_equal(ok, ok_j)
    assert ok.sum() == 5 and not ok[[os.path.basename(f) for f in files].index("broken.wav")]
    assert X.shape == (6, dim)
    assert (X[~ok] == 0).all()
    if dim == 149:
        assert np.abs(X[:, :120] - Xj[:, :120]).max() < 2e-3
        assert np.abs(X[:, 120:144] - Xj[:, 120:144]).max() < 1e-5
    else:
        np.testing.assert_allclose(X[:, :264], Xj[:, :264], rtol=2e-6, atol=1e-3)
        for band in range(14):
            assert np.abs(X[:, 264 + band] - Xj[:, 264 + band]).max() < 1e-3, band
        np.testing.assert_allclose(X[:, 278:], Xj[:, 278:], rtol=1e-6, atol=1e-3)
    names = {w: sorted(f for f in os.listdir(roots[w] / "cache_features")
                       if f.endswith(f"_{sfx}_feats{'' if dim == 149 else '_d286'}.npy"))
             for w in ("torch", "jax" if sfx == "raw" else "jax_clean")}
    assert len(set(map(tuple, names.values()))) == 1 and len(names["torch"]) == 5


def test_extract_corpus_reuses_cache_and_keeps_other_variant(runs):
    """A second run is all cache hits; the 286 entries never touched the 149
    ones (the _d286 namespace)."""
    from stutter_tpu_torch.pipeline import extract_corpus

    root = str(runs["roots"]["torch"])
    for dim, cfg in CFGS.items():
        X, _, _, ok = extract_corpus(root, cfg, "raw", device="cpu")
        X0, _, _, ok0 = runs["torch", dim, "raw"]
        np.testing.assert_array_equal(ok[ok0], True)
        np.testing.assert_array_equal(X[ok0], X0[ok0])
    cache = Path(root) / "cache_features"
    assert len(list(cache.glob("*_raw_feats.npy"))) == len(list(cache.glob("*_raw_feats_d286.npy")))


def test_decode_hooks(runs, tmp_path):
    """A hook registered through the port's own registry
    (stutter_tpu_torch.io.decode.register_decoder) for a format no built-in
    reader takes is used by the port's decode_audio (and was by
    extract_corpus and preprocess above: hooked.ogg has a row); one
    registered in the JAX package's registry is not; an explicit decoder
    reaches Predictor.predict_file; without a hook the file raises in
    decode_audio and becomes an ok=False row."""
    from stutter_tpu_torch.io.decode import decode_audio
    from stutter_tpu_torch.io.native import load_wav_batch
    from stutter_tpu_torch.pipeline import extract_corpus

    ogg = runs["roots"]["torch"] / "segrigated_samples" / "c" / "hooked.ogg"
    with pytest.raises(ValueError, match="RIFF"):
        decode_audio(str(ogg), SR)
    jdecode.register_decoder(".ogg", hooked_decoder)
    try:
        with pytest.raises(ValueError, match="RIFF"):
            decode_audio(str(ogg), SR)
    finally:
        jdecode.unregister_decoder(".ogg")
    register_decoder(".ogg", hooked_decoder)
    try:
        np.testing.assert_array_equal(decode_audio(str(ogg), SR), hooked_decoder(str(ogg), SR))
        audio, lens = load_wav_batch([str(ogg)], 24576, SR)
        assert lens[0] == 12000 and (audio[0, :12000] == hooked_decoder(str(ogg), SR)).all()
    finally:
        unregister_decoder(".ogg")
    explicit = decode_audio(str(ogg), SR, decoder=lambda p, sr: np.ones(7, np.float64))
    assert explicit.dtype == np.float32 and (explicit == 1).all()

    # without the hook, a fresh workspace's .ogg row degrades to ok=False
    root = tmp_path / "nohook"
    shutil.copytree(runs["roots"]["torch"] / "segrigated_samples", root / "segrigated_samples")
    _, _, files, ok = extract_corpus(str(root), CFG, "raw", device="cpu")
    names = [os.path.basename(f) for f in files]
    assert not ok[names.index("hooked.ogg")] and not ok[names.index("broken.wav")]
    assert ok.sum() == 4


@pytest.fixture(scope="module")
def artifacts(runs, tmp_path_factory):
    """286-dim JAX-format artifacts: a numpy-seeded MLP and a scaler fitted on
    the port's cached 286-dim raw features."""
    from stutter_tpu import persist
    from stutter_tpu.models.scaler import LabelEncoder, StandardScaler
    from stutter_tpu.train.trainer import FittedMLP, MLPTrainConfig

    X, _, _, ok = runs["torch", 286, "raw"]
    rng = np.random.RandomState(42)
    dims = (286, *HIDDEN, 3)
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = (rng.randn(2, a, b) * np.sqrt(2.0 / a)).astype(np.float32)
        params[f"b{i}"] = (rng.randn(2, b) * 0.1).astype(np.float32)
    out = tmp_path_factory.mktemp("art") / "output_results"
    out.mkdir()
    persist.save_mlp(out / "model_mlp_tpu",
                     FittedMLP(params=params, n_seeds=2, cfg=MLPTrainConfig(hidden=HIDDEN, n_classes=3)))
    persist.save_scaler(out / "scaler_after.npz", StandardScaler.fit(X[ok]))
    persist.save_label_encoder(out / "label_encoder.json", LabelEncoder(classes_=CLASSES))
    return out


def test_predict_286_variant_matches_jax(runs, artifacts):
    """Predictor on the 286-dim variant with the main.py denoise protocol:
    same label, probabilities within 1e-4 of the JAX Predictor; an explicit
    decoder reaches predict_file."""
    from stutter_tpu.infer import Predictor as JPredictor
    from stutter_tpu_torch.infer import Predictor

    tp = Predictor.load(str(artifacts), CFGS[286], device="cpu")
    jp = JPredictor.load(str(artifacts), JCFGS[286])
    corpus = runs["roots"]["torch"] / "segrigated_samples"
    for path in (corpus / "a" / "tone_1.wav", corpus / "c" / "burst_22k.wav"):
        r, rj = tp.predict_file(str(path)), jp.predict_file(str(path))
        assert r["label"] == rj["label"]
        for c in CLASSES:
            assert abs(r["proba"][c] - rj["proba"][c]) < 1e-4
    ogg = str(corpus / "c" / "hooked.ogg")
    r = tp.predict_file(ogg, decoder=hooked_decoder)
    assert r == tp.predict_clip(hooked_decoder(ogg, SR))
    rj = jp.predict_file(ogg, decoder=hooked_decoder)
    assert r["label"] == rj["label"]


def test_cli_preprocess_extract_predict_on_cpu(runs, artifacts, tmp_path, capsys):
    """`preprocess`, `extract --variant 334 --suffix both` and `predict
    --variant 334 --prop-decrease 0.8` with --device cpu write and print what
    the library calls give."""
    from stutter_tpu_torch import cli

    root = tmp_path / "ws"
    shutil.copytree(runs["roots"]["torch"] / "segrigated_samples", root / "segrigated_samples")
    common = ["--root", str(root), "--device", "cpu", "--prop-decrease", "0.8"]
    assert cli.main(["preprocess", *common]) == 0
    assert "processed 4 files" in capsys.readouterr().out  # no hook: .ogg skipped too
    assert _csv(root / "output_results" / "per_file_analysis.csv")[0] == _csv(
        runs["roots"]["torch"] / "output_results" / "per_file_analysis.csv")[0]
    assert cli.main(["extract", "--variant", "334", "--suffix", "both", *common]) == 0
    printed = capsys.readouterr().out
    assert "raw: 4 vectors x 286 dims cached (2 rows failed decode)" in printed
    assert "clean: 4 vectors x 286 dims cached (2 rows failed decode)" in printed
    for name in ("tone_0_raw_feats_d286.npy", "tone_0_clean_feats_d286.npy"):
        ref = runs["roots"]["torch"] / "cache_features" / name
        np.testing.assert_array_equal(np.load(root / "cache_features" / name), np.load(ref))

    shutil.copytree(artifacts, root / "output_results", dirs_exist_ok=True)
    wav = runs["roots"]["torch"] / "segrigated_samples" / "a" / "tone_1.wav"
    assert cli.main(["predict", str(wav), "--variant", "334", *common]) == 0
    res = json.loads(capsys.readouterr().out)
    from stutter_tpu_torch.infer import Predictor

    assert res == Predictor.load(str(artifacts), CFGS[286], device="cpu").predict_file(str(wav))


def test_denoise_fallback_raises_kernel_errors_and_degrades_bad_clips(monkeypatch, tmp_path):
    """A clip that is not 1-D audio is left raw (None); an error of the
    denoiser itself -- a kernel that fails to build or launch -- propagates
    instead of degrading every clip to raw audio."""
    from stutter_tpu_torch import pipeline
    from stutter_tpu_torch.denoise import denoise_clips

    rng = np.random.RandomState(43)
    good = [(0.2 * rng.randn(n)).astype(np.float32) for n in (9000, 12000)]
    out = pipeline._denoise_with_fallback([good[0], np.zeros((4, 100)), "x", good[1]],
                                          DenoiseConfig(), device="cpu")
    assert out[1] is None and out[2] is None
    for got, ref in zip((out[0], out[3]), denoise_clips(good)):
        np.testing.assert_array_equal(got, ref)

    def failing_denoise(clips, cfg, device):
        raise RuntimeError("spectral_gate_launch: CUDA error 700")

    monkeypatch.setattr(pipeline, "denoise_clips", failing_denoise)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        pipeline._denoise_with_fallback(good, DenoiseConfig(), device="cpu")
    (tmp_path / "segrigated_samples" / "a").mkdir(parents=True)
    write_wav(tmp_path / "segrigated_samples" / "a" / "x.wav", good[0], SR)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        pipeline.preprocess(str(tmp_path), CFG, device="cpu")
    assert not (tmp_path / "clear_audio" / "x.wav").exists()


def test_device_errors_raise_through_extract_corpus(runs, monkeypatch, tmp_path):
    """A kernel error in the extractor, and a device error of the resampler
    on the prefetch thread, raise through extract_corpus; neither becomes an
    ok=False row."""
    from stutter_tpu_torch import pipeline
    from stutter_tpu_torch.io import native

    root = tmp_path / "ws"
    shutil.copytree(runs["roots"]["torch"] / "segrigated_samples", root / "segrigated_samples")

    def failing_extractor(feature_cfg):
        def batch_fn(audio, lengths):
            raise RuntimeError("spectromel_launch: CUDA error 700")
        return batch_fn

    with monkeypatch.context() as m:
        m.setattr(pipeline, "batch_extractor_for", failing_extractor)
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            pipeline.extract_corpus(str(root), CFG, "raw", device="cpu")

    def failing_resample(y, file_sr, sr, device="cpu"):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(native, "to_rate", failing_resample)  # burst_22k.wav needs it
    with pytest.raises(RuntimeError, match="illegal memory access"):
        pipeline.extract_corpus(str(root), CFGS[286], "raw", device="cpu")
    assert not list((root / "cache_features").glob("*_d286.npy"))


def test_denoise_clips_matches_jax_at_main_py_protocol():
    """denoise_clips (the host wrapper preprocess uses) against the JAX
    package's at prop_decrease 0.8, clips of two buckets plus a silent one:
    within the gate's bound of tests/test_denoise.py (atol 5e-5), lengths
    kept, silence stays exactly zero."""
    from stutter_tpu.denoise import denoise_clips as j_denoise_clips
    from stutter_tpu_torch.denoise import denoise_clips

    rng = np.random.RandomState(44)
    t = np.arange(30000) / SR
    clips = [(0.5 * np.sin(2 * np.pi * 440 * t[:n]) * (t[:n] % 0.25 < 0.125)
              + 0.05 * rng.randn(n)).astype(np.float32) for n in (9000, 30000)]
    clips.append(np.zeros(5000, np.float32))
    ours, theirs = denoise_clips(clips, CFG.denoise), j_denoise_clips(clips, JCFG.denoise)
    for y, a, b in zip(clips, ours, theirs):
        assert a.shape == b.shape == y.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-5)
    assert not ours[2].any()
