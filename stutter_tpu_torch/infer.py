"""Single-clip serving (counterpart of stutter_tpu/infer.py's Predictor).

The reference's upload-and-predict path (main.py:1011-1035): resample ->
denoise -> features (149-dim, or the 286-dim variant when cfg.features
asks for it) -> shape guard -> scaler -> seed-averaged MLP.  Every step
runs on the Predictor's device; on a CUDA device the kernels carry the
denoise and feature steps.  A clip crosses to the device
once, padded to its sample bucket, and only the probabilities come back:
the denoised audio goes straight into the feature batch, which holds the
same values the JAX package's host round trip (denoise_clips, then
extract_features_numpy) produces, since both pad to the same bucket with
zeros.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from stutter_tpu_torch.config import PipelineConfig
from stutter_tpu_torch.denoise import denoise_batch
from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.models.mlp import SeedMLP
from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler
from stutter_tpu_torch.ops.frontend import DEFAULT_BUCKETS, batch_extractor_for, pad_to_bucket
from stutter_tpu_torch.ops.resample import resample


@dataclasses.dataclass
class Predictor:
    """Loaded artifacts for serving on one device."""

    scaler: StandardScaler
    label_encoder: LabelEncoder
    model: SeedMLP
    device: torch.device
    cfg: PipelineConfig = PipelineConfig()
    denoise_first: bool = True

    @classmethod
    def load(
        cls, output_dir: str, cfg: PipelineConfig = PipelineConfig(), *,
        device: torch.device | str,
    ) -> "Predictor":
        """Artifacts as the JAX package's persist.py writes them."""
        from stutter_tpu_torch import persist

        dev = resolve_device(device)
        return cls(
            scaler=persist.load_scaler(os.path.join(output_dir, "scaler_after.npz")),
            label_encoder=persist.load_label_encoder(
                os.path.join(output_dir, "label_encoder.json")
            ),
            model=persist.load_mlp(os.path.join(output_dir, "model_mlp_tpu"), device=dev),
            device=dev,
            cfg=cfg,
        )

    def warmup(self, buckets=None, denoise: bool | None = None) -> None:
        """Run every clip bucket once, so the kernels are built and the
        tables uploaded before the first request."""
        for bucket in (buckets if buckets is not None else DEFAULT_BUCKETS):
            self.predict_clip(np.zeros(bucket, np.float32), denoise=denoise)

    @functools.cached_property
    def _scaler_on_device(self) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(self.scaler.mean_, dtype=torch.float32, device=self.device),
                torch.as_tensor(self.scaler.scale_, dtype=torch.float32, device=self.device))

    def _features(self, y: np.ndarray, denoise: bool) -> torch.Tensor:
        """[1, D] features of one clip at the front end's rate, on the device."""
        extract = batch_extractor_for(self.cfg.features)
        bucket = pad_to_bucket(len(y), DEFAULT_BUCKETS)
        n = min(len(y), bucket)
        buf = np.zeros((1, bucket), np.float32)
        buf[0, :n] = y[:n]
        audio = torch.from_numpy(buf).to(self.device)
        lengths = torch.tensor([n], dtype=torch.int32, device=self.device)
        if denoise:
            audio = denoise_batch(audio, lengths, self.cfg.denoise)
        return extract(audio, lengths)

    def predict_clip(self, y: np.ndarray, sr: int = 16000, denoise: bool | None = None) -> dict:
        """One clip -> {label, proba: {class: p}}: denoise -> extract ->
        shape guard -> scale -> predict.  `denoise` overrides the instance
        default for this call."""
        target_sr = self.cfg.features.frontend.sample_rate
        y = np.asarray(y, np.float32)
        if sr != target_sr:
            y = resample(y, sr, target_sr, device=self.device)
        feats = self._features(y, self.denoise_first if denoise is None else denoise)
        # shape guard (ref: main1.py:976-981)
        if feats.shape[1] != self.scaler.n_features_in_:
            raise ValueError(
                f"feature length {feats.shape[1]} != scaler expects "
                f"{self.scaler.n_features_in_}; retrain or clear stale artifacts"
            )
        mean, scale = self._scaler_on_device
        with torch.no_grad():
            proba = self.model((feats - mean) / scale)[0].cpu().numpy()
        pred = int(np.argmax(proba))
        return {
            "label": self.label_encoder.classes_[pred],
            "proba": {c: float(p) for c, p in zip(self.label_encoder.classes_, proba)},
        }

    def predict_file(self, path: str, denoise: bool | None = None, decoder=None) -> dict:
        """Classify one file, resampled to the front end's rate; `decoder`
        (path, sr -> float32 PCM) reads formats the built-in readers do not
        (stutter_tpu_torch.io.decode)."""
        from stutter_tpu_torch.io.decode import decode_audio

        sr = self.cfg.features.frontend.sample_rate
        y = decode_audio(path, sr, decoder=decoder, device=self.device)
        return self.predict_clip(y, sr, denoise=denoise)
