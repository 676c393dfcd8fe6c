"""The port stands alone: nothing under stutter_tpu_torch/, and not
chip_smoke.py, imports the JAX package or JAX, and each copy the port keeps
of a JAX-package module (config, data, cache, the CSV writer, io.wav,
io.mp3, the decoder registry, the C++ WAV loader, ops.filterbanks,
utils.profiling, serve's upload sniffing and cap, persist's parameter
flattening) gives what the original gives."""

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
assert len(names) >= 38, names
need = {'serve', 'train.seq_pipeline', 'train.seq_trainer', 'models.cnn', 'models.cnn_bilstm',
        'models.transformer'}
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
