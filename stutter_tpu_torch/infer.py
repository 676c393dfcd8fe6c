"""Serving (counterpart of stutter_tpu/infer.py): the feature-MLP
`Predictor`, the sequence heads' `SeqPredictor`, the weighted-vote
`EnsemblePredictor`, and streaming windowed inference for the MLP and the
vote.

The reference's upload-and-predict path (main.py:1011-1035): resample ->
denoise -> features (149-dim, or the 286-dim variant when cfg.features
asks for it) -> shape guard -> scaler -> seed-averaged MLP.  The sequence
heads run denoise -> log-mel or MFCC+delta frames -> per-member
standardization -> head -> softmax, and the vote weighs the members'
probabilities.  Every step runs on the predictor's device; on a CUDA
device the kernels carry the denoise and feature steps.  A request (one
clip, a micro-batch of clips, one stream segment) crosses to the device in
one copy -- the audio zero-padded to its sample bucket with the lengths
behind it in the same buffer -- and only probabilities come back.

Streams cut the signal into segments of `seg_samples` (~65 s); a segment
crosses once and its overlapping windows are rebuilt on the device:
frame-row gathers of the segment for the MLP, frame-range slices of one
shared mel spectrogram for the vote.  Window starts round to the 512-sample
frame grid.  The host stages segment k+1 while segment k runs.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from stutter_tpu_torch.config import PipelineConfig
from stutter_tpu_torch.denoise import denoise_batch, denoise_clips
from stutter_tpu_torch.device import resolve_device
from stutter_tpu_torch.models.mlp import SeedMLP
from stutter_tpu_torch.models.scaler import LabelEncoder, StandardScaler
from stutter_tpu_torch.models.transformer import Transformer
from stutter_tpu_torch.ops.frontend import (
    DEFAULT_BUCKETS,
    batch_extractor_for,
    extract_features_numpy,
    pad_to_bucket,
)
from stutter_tpu_torch.ops.resample import resample
from stutter_tpu_torch.ops.spectral import db_from_mel
from stutter_tpu_torch.ops.spectromel import spectromel
from stutter_tpu_torch.train.seq_trainer import fit_frames, frames_from_db, seq_frames

T_MAX = 316  # the frame axis the sequence heads were trained at


def _resample_to(y: np.ndarray, sr: int, target_sr: int, device) -> np.ndarray:
    """`y` at target_sr: the front end is trained there, so a library
    caller's other rate is resampled, not silently mis-featurized."""
    y = np.asarray(y, np.float32)
    return y if sr == target_sr else resample(y, sr, target_sr, device=device)


def _stage(device: torch.device, rows: int, n: int, n_ints: int):
    """A float32 staging buffer for one host-to-device copy, pinned for a
    CUDA device: -> (buffer, its [rows, n] audio view, its n_ints integer
    slots, which hold values below 2**24 exactly)."""
    buf = torch.zeros(rows * n + n_ints, dtype=torch.float32,
                      pin_memory=device.type == "cuda")
    a = buf.numpy()
    return buf, a[: rows * n].reshape(rows, n), a[rows * n :]


def _upload(buf: torch.Tensor, rows: int, n: int, device: torch.device):
    """The staged buffer on `device` in one copy -> (audio [rows, n], int32
    slots)."""
    t = buf.to(device, non_blocking=True)
    return t[: rows * n].view(rows, n), t[rows * n :].to(torch.int32)


def _stage_clips(clips, n: int, device: torch.device):
    """Clips zero-padded (or cut) to n samples -> (audio [B, n], lengths
    [B] int32) on `device` in one copy, and the host lengths."""
    buf, rows, ints = _stage(device, len(clips), n, len(clips))
    lens = np.zeros(len(clips), np.int64)
    for i, y in enumerate(clips):
        m = min(len(y), n)
        rows[i, :m] = y[:m]
        lens[i] = m
    ints[:] = lens
    audio, lengths = _upload(buf, len(clips), n, device)
    return audio, lengths, lens


def _segments(starts: list[int], s_eff: int):
    """Window starts -> (segment start, the starts inside it): segment k
    holds the windows that start in [seg0, seg0 + s_eff)."""
    si = 0
    while si < len(starts):
        seg0 = (starts[si] // s_eff) * s_eff
        seg_starts = []
        while si < len(starts) and starts[si] < seg0 + s_eff:
            seg_starts.append(starts[si])
            si += 1
        yield seg0, seg_starts


def _stream_windows(n: int, sr: int, window_s: float, hop_s: float) -> tuple[int, list[int]]:
    """A stream of n samples -> (the window, rounded up to whole 512-sample
    frames; the window starts)."""
    win = -(-int(window_s * sr) // 512) * 512
    return win, list(range(0, max(n - win // 2, 1), int(hop_s * sr)))


def _stream(y: np.ndarray, starts: list[int], seg: int, win: int, sr: int, classes, device,
            forward, rows=lambda probs: probs) -> list[dict]:
    """The stream loop both predictors share -> [{start_s, end_s, label,
    proba}] a window.  Each segment of `seg` samples crosses to the device
    in one copy, with its valid samples and its windows' start frames
    behind the audio; `forward(audio [1, seg], length [1], start frames
    [W], the same on the host, valid host samples)` gives its device
    probabilities, and `rows` turns their host copy into [W, C] rows.  One
    segment stays in flight while the host stages the next.  Window starts
    round to the frame grid."""
    results: list[dict] = []
    pending = []  # (aligned starts, device probabilities)

    def flush(aligned, probs):
        for a0, p in zip(aligned, rows(probs.cpu().numpy())):
            results.append({
                "start_s": a0 / sr,
                "end_s": min(a0 + win, len(y)) / sr,
                "label": classes[int(np.argmax(p))],
                "proba": {c: float(v) for c, v in zip(classes, p)},
            })

    for seg0, seg_starts in _segments(starts, seg - win):
        part = y[seg0 : seg0 + seg]
        frames = np.asarray([int(round((s0 - seg0) / 512)) for s0 in seg_starts], np.int64)
        buf, audio_h, ints = _stage(device, 1, seg, 1 + len(frames))
        audio_h[0, : len(part)] = part
        ints[0], ints[1:] = len(part), frames
        audio, ints_d = _upload(buf, 1, seg, device)
        with torch.no_grad():
            probs = forward(audio, ints_d[:1], ints_d[1:], frames, len(part))
        pending.append(([seg0 + int(f) * 512 for f in frames], probs))
        if len(pending) > 1:
            flush(*pending.pop(0))
    for item in pending:
        flush(*item)
    return results


@dataclasses.dataclass
class Predictor:
    """Loaded feature-MLP artifacts for serving on one device."""

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
        audio, lengths, _ = _stage_clips([y], pad_to_bucket(len(y), DEFAULT_BUCKETS),
                                         self.device)
        if denoise:
            audio = denoise_batch(audio, lengths, self.cfg.denoise)
        return batch_extractor_for(self.cfg.features)(audio, lengths)

    def _check_width(self, n: int) -> None:
        # shape guard (ref: main1.py:976-981)
        if n != self.scaler.n_features_in_:
            raise ValueError(
                f"feature length {n} != scaler expects "
                f"{self.scaler.n_features_in_}; retrain or clear stale artifacts"
            )

    def predict_clip(self, y: np.ndarray, sr: int = 16000, denoise: bool | None = None) -> dict:
        """One clip -> {label, proba: {class: p}}: denoise -> extract ->
        shape guard -> scale -> predict.  `denoise` overrides the instance
        default for this call."""
        y = _resample_to(y, sr, self.cfg.features.frontend.sample_rate, self.device)
        feats = self._features(y, self.denoise_first if denoise is None else denoise)
        self._check_width(feats.shape[1])
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

    def predict_stream(
        self,
        y: np.ndarray,
        sr: int = 16000,
        window_s: float = 3.0,
        hop_s: float = 1.0,
        seg_samples: int = 1 << 20,
    ) -> list[dict]:
        """Long audio -> per-window predictions [{start_s, end_s, label,
        proba}] over overlapping windows (no denoise, as in the JAX
        package).  Each segment crosses to the device once; its windows are
        rebuilt there as gathers of 512-sample frame rows, then extracted
        and classified together (one batch a segment).  For frame-aligned
        starts a window equals predict_clip of the same samples."""
        extract = batch_extractor_for(self.cfg.features)
        sr_t = self.cfg.features.frontend.sample_rate
        y = _resample_to(y, sr, sr_t, self.device)
        win, starts = _stream_windows(len(y), sr_t, window_s, hop_s)
        # the JAX package's segment size: a power of two up to seg_samples,
        # at least two windows
        need = starts[-1] + 2 * win
        seg = max(min(seg_samples, 1 << (need - 1).bit_length()), 2 * win)
        seg = -(-seg // 512) * 512
        mean, scale = self._scaler_on_device
        rows_ix = torch.arange(win // 512, device=self.device)

        def forward(audio, length, starts_f, frames, _n):
            idx = starts_f[:, None] + rows_ix[None, :]  # [W, win / 512]
            batch = audio.reshape(-1, 512)[idx].reshape(len(frames), win)
            # samples past the signal are the buffer's zeros
            lens = torch.clamp(length - starts_f * 512, 1, win).to(torch.int32)
            feats = extract(batch, lens)
            self._check_width(feats.shape[1])
            return self.model((feats - mean) / scale)

        return _stream(y, starts, seg, win, sr_t, self.label_encoder.classes_, self.device,
                       forward)


@dataclasses.dataclass
class SeqPredictor:
    """Serving wrapper for a trained sequence head (CNN / CNN-BiLSTM /
    transformer): the model_<arch>.npz + _norm.npz + .json artifacts the
    JAX package's run_seq writes, run as denoise -> featurize ->
    standardize -> head on the device."""

    arch: str
    kind: str
    model: torch.nn.Module
    mean: np.ndarray
    std: np.ndarray
    classes_: list[str]
    device: torch.device
    cfg: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    denoise_first: bool = True

    @classmethod
    def load(
        cls, output_dir: str, arch: str = "cnn", cfg: PipelineConfig = PipelineConfig(), *,
        device: torch.device | str,
    ) -> "SeqPredictor":
        from stutter_tpu_torch import persist
        from stutter_tpu_torch.train.seq_pipeline import ARCHS

        dev = resolve_device(device)
        params, mean, std, meta = persist.load_seq_head(output_dir, arch)
        return cls(
            arch=arch, kind=meta["kind"],
            model=ARCHS[arch]["module"].from_jax_params(params, device=dev),
            mean=mean, std=std, classes_=list(meta["classes"]), device=dev, cfg=cfg,
        )

    @functools.cached_property
    def _groups(self) -> list["_Group"]:
        return _member_groups([self])

    def warmup(self, buckets=None, denoise: bool | None = None) -> None:
        """Run every clip bucket once (kernels built, tables uploaded)."""
        for bucket in (buckets if buckets is not None else DEFAULT_BUCKETS):
            self.predict_clip(np.zeros(bucket, np.float32), denoise=denoise)

    def predict_clip(
        self, y: np.ndarray, sr: int = 16000, denoise: bool | None = None
    ) -> dict:
        """One clip -> {label, proba: {class: p}} via the sequence head."""
        sr_t = self.cfg.features.frontend.sample_rate
        y = _resample_to(y, sr, sr_t, self.device)
        do_denoise = self.denoise_first if denoise is None else denoise
        proba = _seq_vote_batch([y], self._groups, 1, self.cfg, do_denoise, sr_t,
                                self.device)[0, 0]
        pred = int(np.argmax(proba))
        return {
            "label": self.classes_[pred],
            "proba": {c: float(p) for c, p in zip(self.classes_, proba)},
        }

    def predict_file(self, path: str, denoise: bool | None = None, decoder=None) -> dict:
        from stutter_tpu_torch.io.decode import decode_audio

        sr = self.cfg.features.frontend.sample_rate
        y = decode_audio(path, sr, decoder=decoder, device=self.device)
        return self.predict_clip(y, sr, denoise=denoise)


@dataclasses.dataclass
class _BothFeatsMLP:
    """Optional vote member over the raw + clean feature concatenation; it
    needs both the raw clip and the denoised one."""

    scaler: StandardScaler
    model: SeedMLP
    classes_: list[str]
    cfg: PipelineConfig
    device: torch.device

    def predict_pair(self, y_raw: np.ndarray, y_clean: np.ndarray) -> dict:
        feats = extract_features_numpy([y_raw, y_clean], self.cfg.features, device=self.device)
        x = np.concatenate([feats[0], feats[1]])[None, :]
        if x.shape[1] != self.scaler.n_features_in_:
            raise ValueError(
                f"feature length {x.shape[1]} != scaler expects "
                f"{self.scaler.n_features_in_}; retrain or clear stale artifacts"
            )
        xs = torch.as_tensor(self.scaler.transform(x).astype(np.float32), device=self.device)
        with torch.no_grad():
            proba = self.model(xs)[0].cpu().numpy()
        return {"proba": {c: float(p) for c, p in zip(self.classes_, proba)}}


@dataclasses.dataclass
class _Group:
    """Sequence members that run as one forward: the transformers of equal
    shapes stacked into one module, any other head alone."""

    kind: str
    model: torch.nn.Module
    mean: torch.Tensor  # [M, D]
    std: torch.Tensor  # [M, D]
    members: list[int]  # their places in the vote's member order


def _member_groups(seq_members: list[SeqPredictor]) -> list[_Group]:
    """Group the members as the JAX package's _member_forwards does (same
    kind, architecture and weight shapes); here only the transformer's
    module stacks, so other heads each form their own group."""
    stacks: dict = {}
    groups = []
    for i, m in enumerate(seq_members):
        if isinstance(m.model, Transformer):
            sig = (m.kind, tuple((k, tuple(v.shape)) for k, v in m.model.p.items()))
            stacks.setdefault(sig, []).append(i)
        else:
            stacks[("single", i)] = [i]
    for idxs in stacks.values():
        ms = [seq_members[i] for i in idxs]
        model = ms[0].model if len(ms) == 1 else Transformer.stack([m.model for m in ms])

        def norm(attr, ms=ms):
            return torch.as_tensor(np.stack([getattr(m, attr) for m in ms]),
                                   dtype=torch.float32, device=ms[0].device)

        groups.append(_Group(ms[0].kind, model, norm("mean"), norm("std"), idxs))
    return groups


def _member_forwards(feats: dict, groups: list[_Group], n_members: int) -> torch.Tensor:
    """Member forwards over the shared per-kind frames -> [M, B, C]
    probabilities.  feats: kind -> (frames [B, t_max, D], valid frames [B]
    on the device, the same on the host)."""
    probs: list = [None] * n_members
    for g in groups:
        f, nv, nv_host = feats[g.kind]
        mb = torch.arange(f.shape[1], device=f.device)[None, :] < nv[:, None]
        xs = (f[None] - g.mean[:, None, None]) / g.std[:, None, None] * mb[None, :, :, None]
        if isinstance(g.model, Transformer):
            logits = g.model(xs, mb)
        else:
            logits = g.model(xs[0], mb, nv_host)[None]
        p = torch.softmax(logits, dim=-1)
        for j, i in enumerate(g.members):
            probs[i] = p[j]
    return torch.stack(probs)


def _seq_vote_batch(clips, groups, n_members, cfg, denoise: bool, sr: int,
                    device) -> np.ndarray:
    """Clips at the front end's rate -> [M, B, C] member probabilities on
    the host: one copy in (the clips padded to the largest bucket among
    them; frame masking makes the bucket invisible to the features), the
    gate, one spectrogram with each feature kind's frames from it (shared
    by the kind's members), every member forward, one copy out.

    The gate is not bucket-invariant -- its backward smoothing runs in from
    the end of the padded buffer -- so each bucket's clips are gated at
    their own bucket, as predict_clip gates them (the JAX package's
    predict_batch gates at the largest bucket: ~2e-3 of probability drift
    for a short clip batched with a long one)."""
    buckets = np.array([pad_to_bucket(len(s), DEFAULT_BUCKETS) for s in clips])
    order = np.argsort(buckets, kind="stable")  # each bucket's rows contiguous
    audio, lengths, lens = _stage_clips([clips[i] for i in order], int(buckets.max()), device)
    with torch.no_grad():
        if denoise:
            gated = torch.zeros_like(audio)
            for b in np.unique(buckets):
                rows = np.flatnonzero(buckets[order] == b)
                r = slice(rows[0], rows[-1] + 1)
                gated[r, :b] = denoise_batch(audio[r, :b].contiguous(), lengths[r], cfg.denoise)
            audio = gated
        P = _vote_frames(audio, lengths, lens, groups, n_members, sr)
    return P.cpu().numpy()[:, np.argsort(order)]


def _vote_frames(audio, lengths, lens, groups, n_members, sr: int,
                 t_max: int = T_MAX) -> torch.Tensor:
    """Audio [B, N] at the front end's rate (gated or not), lengths [B] on
    the device and the same on the host -> [M, B, C]: one spectrogram, each
    feature kind's frames from it (shared by the kind's members), every
    member forward."""
    nv = torch.clamp(1 + torch.div(lengths, 512, rounding_mode="floor"), max=t_max)
    nv_host = np.minimum(1 + np.asarray(lens) // 512, t_max)
    frames, _ = seq_frames(audio, lengths, {g.kind for g in groups}, sr)
    feats = {kind: (fit_frames(f, t_max), nv, nv_host) for kind, f in frames.items()}
    return _member_forwards(feats, groups, n_members)


def _ensemble_fused(audio, lengths, lens, groups, n_members, dn_cfg, denoise: bool, sr: int,
                    t_max: int = T_MAX) -> torch.Tensor:
    """The JAX package's _ensemble_seq_fused_impl (stutter_tpu/infer.py:402):
    audio [B, N] gated at N as one batch (not per bucket, as _seq_vote_batch
    gates), then _vote_frames -> [M, B, C] on the device.
    parallel.mesh.ensemble_sharded runs it per shard."""
    with torch.no_grad():
        if denoise:
            audio = denoise_batch(audio, lengths, dn_cfg)
        return _vote_frames(audio, lengths, lens, groups, n_members, sr, t_max)


def _ensemble_stream(audio, length, starts_f, nv_host, groups, n_members, dn_cfg,
                     denoise: bool, w_frames: int, win: int, sr: int,
                     t_max: int = T_MAX) -> torch.Tensor:
    """One stream segment through the vote: gate the segment once, its
    power spectrum and linear mel once, then every window is a frame-range
    slice of that mel; the dB clamp's reference is the window's own max and
    the deltas run per window, as the per-window path has them.  The heads
    run at t_max frames, zero-padded: 'SAME' padding depends on the frame
    count, so another length would shift every conv grid.

    audio [1, S], length [1] valid samples, starts_f [W] window starts in
    frames, nv_host [W] the windows' valid frames -> [M, W, C]."""
    if denoise:
        audio = denoise_batch(audio, length, dn_cfg)
    _, mel, _ = spectromel(audio, length, sr=sr, n_fft=2048, hop_length=512, n_mels=128,
                           with_stats=False, with_tuning=False)
    mel = mel[0]  # [T_seg, 128], zero past the signal
    idx = starts_f[:, None] + torch.arange(w_frames, device=mel.device)[None, :]
    idx = torch.clamp(idx, max=mel.shape[0] - 1)
    nv_w = 1 + torch.div(torch.clamp(length - starts_f * 512, 0, win), 512, rounding_mode="floor")
    mb = torch.arange(w_frames, device=mel.device)[None, :] < nv_w[:, None]
    mel_w = torch.where(mb[:, :, None], mel[idx], 0.0)  # [W, w_frames, 128]
    frames = frames_from_db(db_from_mel(mel_w, mb), nv_w, {g.kind for g in groups})
    feats = {kind: (fit_frames(f, t_max), nv_w, nv_host) for kind, f in frames.items()}
    return _member_forwards(feats, groups, n_members)


@dataclasses.dataclass
class EnsemblePredictor:
    """Serving wrapper for the nested weighted soft vote, the project's
    headline model: the members' artifacts as the JAX package's
    run_cv(include_seq=True) writes them (sequence heads model_<arch>*,
    optional MLP members, ensemble.json with the fold-averaged weights)."""

    members: dict  # name -> Predictor | SeqPredictor | _BothFeatsMLP
    weights: dict  # name -> float
    classes_: list[str]
    device: torch.device
    cfg: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    denoise_first: bool = True

    @classmethod
    def load(
        cls, output_dir: str, cfg: PipelineConfig = PipelineConfig(), *,
        device: torch.device | str,
    ) -> "EnsemblePredictor":
        """Members of zero weight are not loaded; a member whose class order
        differs from ensemble.json's raises (stale artifacts)."""
        import json
        from pathlib import Path

        from stutter_tpu_torch import persist

        dev = resolve_device(device)
        meta = json.loads(Path(output_dir, "ensemble.json").read_text())
        members: dict = {}
        for name, w in meta["weights"].items():
            if w <= 0.0:
                # the nested weight search zeroes members that hurt the vote
                continue
            if name == "mlp":
                # artifacts from before the dedicated members: engine B's MLP
                members[name] = Predictor.load(output_dir, cfg, device=dev)
                classes = members[name].label_encoder.classes_
            elif name in ("mlp_clean", "mlp_both"):
                le = persist.load_label_encoder(os.path.join(output_dir, "label_encoder.json"))
                scaler = persist.load_scaler(os.path.join(output_dir, f"scaler_{name[4:]}.npz"))
                model = persist.load_mlp(os.path.join(output_dir, f"model_{name}_tpu"),
                                         device=dev)
                members[name] = (
                    Predictor(scaler=scaler, label_encoder=le, model=model, device=dev, cfg=cfg)
                    if name == "mlp_clean"
                    else _BothFeatsMLP(scaler=scaler, model=model, classes_=le.classes_,
                                       cfg=cfg, device=dev))
                classes = le.classes_
            else:
                members[name] = SeqPredictor.load(output_dir, name, cfg, device=dev)
                classes = members[name].classes_
            if list(classes) != list(meta["classes"]):
                raise ValueError(
                    f"member {name!r} class order {classes} != ensemble "
                    f"{meta['classes']}; retrain (stale artifacts)"
                )
        return cls(members=members, weights=meta["weights"],
                   classes_=list(meta["classes"]), device=dev, cfg=cfg)

    @functools.cached_property
    def _seq(self) -> tuple[list[str], list[_Group]]:
        """The sequence members' names, in order, and their forward groups."""
        names = [n for n, m in self.members.items() if isinstance(m, SeqPredictor)]
        return names, _member_groups([self.members[n] for n in names])

    def warmup(self, buckets=None, denoise: bool | None = None,
               batch_sizes: tuple = ()) -> None:
        """Run every clip bucket once, and predict_batch at `batch_sizes`
        rows (serve passes the micro-batcher's): the first pass at a new
        batch size builds the libraries' per-shape plans (~20 ms a clip at
        B=8, against ~1.5 warm, on an H100; PERF.md)."""
        for bucket in (buckets if buckets is not None else DEFAULT_BUCKETS):
            self.predict_clip(np.zeros(bucket, np.float32), denoise=denoise)
            for b in batch_sizes:
                self.predict_batch([np.zeros(bucket, np.float32)] * b, denoise=denoise)

    def predict_clip(
        self, y: np.ndarray, sr: int = 16000, denoise: bool | None = None
    ) -> dict:
        """One clip -> {label, proba, members}."""
        return self.predict_batch([y], sr=sr, denoise=denoise)[0]

    def _vote(self, member_probs: dict) -> np.ndarray:
        proba = np.zeros(len(self.classes_), np.float64)
        for name, p in member_probs.items():
            proba += self.weights[name] * np.asarray(p)
        return proba / max(proba.sum(), 1e-12)

    def predict_batch(
        self, clips: list, sr: int = 16000, denoise: bool | None = None
    ) -> list[dict]:
        """Several independent clips in one pass (the micro-batcher's entry
        point): each result equals predict_clip of its clip.  The sequence
        members share one copy in, one device pass (gate, each feature kind
        once, every member forward) and one [M, B, C] copy out; MLP members,
        off in the production vote, run per clip on the host-denoised
        audio."""
        sr_t = self.cfg.features.frontend.sample_rate
        clips = [_resample_to(y, sr, sr_t, self.device) for y in clips]
        do_denoise = self.denoise_first if denoise is None else denoise
        seq_names, groups = self._seq
        others = [(n, m) for n, m in self.members.items() if n not in seq_names]
        member_out: list[dict] = [{} for _ in clips]
        raws = clips
        if others and do_denoise:
            # non-sequence members need the denoised waveform on the host
            clips = denoise_clips(clips, self.cfg.denoise, device=self.device)
        if seq_names:
            # the gate runs inside the device pass unless the host denoised
            P = _seq_vote_batch(clips, groups, len(seq_names), self.cfg,
                                do_denoise and not others, sr_t, self.device)
            for mi, name in enumerate(seq_names):
                for i in range(len(clips)):
                    member_out[i][name] = P[mi, i]
        for name, member in others:
            for i in range(len(clips)):
                if isinstance(member, _BothFeatsMLP):
                    r = member.predict_pair(raws[i], clips[i])
                else:
                    r = member.predict_clip(clips[i], sr_t, denoise=False)
                member_out[i][name] = [r["proba"][c] for c in self.classes_]
        results = []
        for out in member_out:
            proba = self._vote(out)
            results.append({
                "label": self.classes_[int(np.argmax(proba))],
                "proba": {c: float(p) for c, p in zip(self.classes_, proba)},
                "members": {n: {c: float(v) for c, v in zip(self.classes_, p)}
                            for n, p in out.items()},
            })
        return results

    def predict_file(self, path: str, denoise: bool | None = None, decoder=None) -> dict:
        from stutter_tpu_torch.io.decode import decode_audio

        sr = self.cfg.features.frontend.sample_rate
        y = decode_audio(path, sr, decoder=decoder, device=self.device)
        return self.predict_clip(y, sr, denoise=denoise)

    def predict_stream(
        self,
        y: np.ndarray,
        sr: int = 16000,
        window_s: float = 3.0,
        hop_s: float = 1.0,
        batch_size: int = 16,
        denoise: bool | None = None,
        seg_samples: int = 1 << 20,
    ) -> list[dict]:
        """Long audio -> per-window predictions through the whole vote.
        Each segment is gated and its spectrogram computed once; the windows
        are frame-range slices of it (_ensemble_stream).  A vote with
        non-sequence members falls back to predict_batch over the windows,
        `batch_size` at a time."""
        sr_t = self.cfg.features.frontend.sample_rate
        y = _resample_to(y, sr, sr_t, self.device)
        win, starts = _stream_windows(len(y), sr_t, window_s, hop_s)
        seq_names, groups = self._seq
        if len(seq_names) < len(self.members):
            results = []
            for s in range(0, len(starts), batch_size):
                chunk = starts[s : s + batch_size]
                outs = self.predict_batch([y[s0 : s0 + win] for s0 in chunk], sr_t,
                                          denoise=denoise)
                results.extend({"start_s": s0 / sr_t, "end_s": min(s0 + win, len(y)) / sr_t,
                                "label": o["label"], "proba": o["proba"]}
                               for s0, o in zip(chunk, outs))
            return results

        seg = -(-max(seg_samples, 2 * win) // 512) * 512
        w_frames = win // 512 + 1
        if w_frames > T_MAX:
            raise ValueError(
                f"stream window {window_s}s exceeds the heads' trained frame "
                f"capacity (t_max={T_MAX} frames = {(T_MAX - 1) * 512 / sr_t:.1f}s)"
            )
        do_denoise = self.denoise_first if denoise is None else denoise

        def forward(audio, length, starts_f, frames, n):
            nv_host = 1 + np.clip(n - frames * 512, 0, win) // 512
            return _ensemble_stream(audio, length, starts_f, nv_host, groups, len(seq_names),
                                    self.cfg.denoise, do_denoise, w_frames, win, sr_t)

        def vote(P):  # [M, W, C] -> [W, C]
            return [self._vote({n: P[mi, j] for mi, n in enumerate(seq_names)})
                    for j in range(P.shape[1])]

        return _stream(y, starts, seg, win, sr_t, self.classes_, self.device, forward, vote)
