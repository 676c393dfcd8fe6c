"""The reference against the port's plain path, at a tiny size on the CPU."""

import json
import tempfile
from pathlib import Path

import numpy as np
import torch

import gen
from reference import dsp
from reference.config import denoise_config
from reference.quint import Quint, decode_wav

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def config(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


def clips(n=3):
    return [gen.recording_clip(5, i, int(d * 16000), 16000)
            for i, d in enumerate((0.6, 2.2, 3.4)[:n])]


def test_gate_and_features_equal_the_ports_plain_path():
    from stutter_tpu_torch.config import FEATURES_149, DenoiseConfig
    from stutter_tpu_torch.denoise import denoise_clips
    from stutter_tpu_torch.ops.frontend import extract_features_numpy

    cfg = config("mlp149")
    ys = clips()
    port_clean = denoise_clips(ys, DenoiseConfig(**cfg["denoise"]), device="cpu")
    port_feats = extract_features_numpy(ys, FEATURES_149, device="cpu")
    for y, pc, pf in zip(ys, port_clean, port_feats):
        rc = dsp.denoise_clip(y, denoise_config(cfg["denoise"]), "cpu")
        np.testing.assert_allclose(rc, pc, atol=1e-6)
        rf = dsp.features_149_clip(y, cfg["frontend"], "cpu")
        np.testing.assert_allclose(rf, pf, rtol=1e-5, atol=1e-5)


def test_resampler_equals_the_ports():
    from stutter_tpu_torch.ops.resample import resample

    y = gen.recording_clip(6, 0, 22050 * 2, 22050)
    np.testing.assert_allclose(dsp.resample(y, 22050, 16000, "cpu"),
                               resample(y, 22050, 16000, device="cpu"), atol=1e-6)


def test_wav_decode_equals_the_ports():
    from stutter_tpu_torch.io.wav import read_wav

    body = gen.upload(3, 1, 0.7, 22050, 0.5)
    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(body)
        f.flush()
        want, sr = read_wav(f.name)
    got, got_sr = decode_wav(body)
    assert got_sr == sr == 22050
    np.testing.assert_array_equal(got, want)


def test_quint_members_and_vote_equal_the_ports():
    sys_path_kind = Path(__file__).resolve().parent.parent / "traffic"
    import importlib.util

    spec = importlib.util.spec_from_file_location("http_open_t", sys_path_kind / "http_open.py")
    kind = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kind)
    from stutter_tpu_torch.infer import EnsemblePredictor

    cfg = config("quint_vote")
    with tempfile.TemporaryDirectory() as d:
        kind.write_artifacts(cfg, d, 11, "cpu")
        port = EnsemblePredictor.load(d, device="cpu")
        ref = Quint(d, {n: m["weight"] for n, m in cfg["members"].items()},
                    {n: m["arch"] for n, m in cfg["members"].items()}, cfg["classes"],
                    denoise_config(cfg["denoise"]), 16000, "cpu")
        for y in clips(2):
            got = port.predict_clip(y)
            members = ref.member_probs(y)
            for name, p in members.items():
                np.testing.assert_allclose([got["members"][name][c] for c in cfg["classes"]],
                                           p, atol=1e-5)
            np.testing.assert_allclose([got["proba"][c] for c in cfg["classes"]],
                                       ref.vote(members), atol=1e-5)
    assert torch.get_num_threads() <= 4
