"""The weighted soft vote over the sequence heads, one clip at a time:
decode the upload, resample to the front end's rate, gate, featurize,
standardize with each member's statistics, run each member's head alone,
softmax, and weigh.  The heads are the frozen copies beside this file; the
weights and statistics are read from the files the benchmark wrote for
both sides."""

from __future__ import annotations

import io
import json
import os
import wave

import numpy as np
import torch

from . import dsp
from .cnn import CNN
from .cnn_bilstm import CNNBiLSTM
from .config import DenoiseConfig
from .transformer import Transformer

MODULES = {"cnn": CNN, "cnn_bilstm": CNNBiLSTM, "transformer": Transformer}


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """A PCM16 WAV upload -> (mono float32 in [-1, 1), its rate)."""
    with wave.open(io.BytesIO(data)) as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"expected PCM16, got {8 * w.getsampwidth()}-bit samples")
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2").reshape(-1, w.getnchannels())
        return (pcm.astype(np.float32) / 32768.0).mean(axis=1), w.getframerate()


class Quint:
    """The members listed in `weights` (name -> vote weight), each read
    from model_<name>.npz, model_<name>_norm.npz and model_<name>.json
    under `out_dir`."""

    def __init__(self, out_dir: str, weights: dict, arch_of: dict, classes: list,
                 denoise_cfg: DenoiseConfig, sr: int, device):
        self.weights, self.classes, self.cfg, self.sr = weights, classes, denoise_cfg, sr
        self.device = torch.device(device)
        self.members = {}
        for name in weights:
            with np.load(os.path.join(out_dir, f"model_{name}.npz")) as z:
                params = dict(z)
            with np.load(os.path.join(out_dir, f"model_{name}_norm.npz")) as z:
                mean, std = z["mean"], z["std"]
            with open(os.path.join(out_dir, f"model_{name}.json")) as f:
                kind = json.load(f)["kind"]
            model = MODULES[arch_of[name]].from_jax_params(params, device=self.device)
            self.members[name] = (kind, model, torch.as_tensor(mean, device=self.device),
                                  torch.as_tensor(std, device=self.device))

    @torch.no_grad()
    def member_probs(self, y: np.ndarray) -> dict:
        """One clip at the front end's rate -> {member: [C] probabilities}."""
        audio, length = dsp.padded(y, self.device)
        audio = dsp.denoise(audio, length, self.cfg)
        kinds = {kind for kind, *_ in self.members.values()}
        frames, nv = dsp.seq_frames(audio, length, kinds, self.sr)
        mask = torch.arange(dsp.T_MAX, device=self.device)[None, :] < nv[:, None]
        out = {}
        for name, (kind, model, mean, std) in self.members.items():
            xs = (frames[kind] - mean) / std * mask[:, :, None]
            logits = model(xs, mask, nv.cpu().numpy())
            out[name] = torch.softmax(logits, dim=-1)[0].double().cpu().numpy()
        return out

    def vote(self, member_probs: dict) -> np.ndarray:
        proba = np.zeros(len(self.classes))
        for name, p in member_probs.items():
            proba += self.weights[name] * p
        return proba / max(proba.sum(), 1e-12)

    def predict_upload(self, data: bytes) -> dict:
        """An upload's bytes -> {"proba": [C], "members": {name: [C]}}."""
        y, file_sr = decode_wav(data)
        if file_sr != self.sr:
            y = dsp.resample(y, file_sr, self.sr, self.device)
        members = self.member_probs(y)
        return {"proba": self.vote(members), "members": members}
