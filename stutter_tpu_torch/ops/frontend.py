"""Batched feature extraction (counterpart of stutter_tpu/ops/frontend.py).

The reference's canonical 149-dim feature contract (pipeline1.py:206-265):

  [mfcc mean(20) | mfcc std(20) | delta mean/std(40) | delta2 mean/std(40) |
   chroma mean(12) | chroma std(12) | text(5)]

Clips are padded into sample-count buckets (multiples of the hop); every
statistic is masked to each clip's own frame count, so a batch gives what
each clip gives alone.  Two fused ops carry it, each a CUDA kernel for CUDA
tensors and a plain PyTorch version for CPU tensors: `spectromel` (power,
MFCC/delta statistics, tuning bin) and `chroma_stats`.  The 286-dim variant
(ops/frontend334.py) goes through `spect_mel_db`, the spectromel kernel's
mel-output mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from stutter_tpu_torch.config import FEATURES_149
from stutter_tpu_torch.ops.chroma_stats import chroma_stats
from stutter_tpu_torch.ops.masked import frame_mask, masked_mean_std
from stutter_tpu_torch.ops.spectral import db_from_mel
from stutter_tpu_torch.ops.spectromel import spectromel
from stutter_tpu_torch.parallel.mesh import resolve_mesh, shard_batch
from stutter_tpu_torch.utils.profiling import count, span, tracing

# Sample-count buckets (multiples of hop=512) covering 0.45-10.1 s at 16 kHz.
DEFAULT_BUCKETS = (24576, 49152, 98304, 163840)


def spect_mel_db(audio, lengths, sr, n_fft, hop_length, n_mels, n_chroma=12, with_tuning=True):
    """(masked power [B, T, K], mask [B, T], log-mel dB [B, T, M], tuning bin
    [B], or None with with_tuning=False) for the batch, from the spectromel
    kernel's mel-output mode (a CUDA tensor) or its plain version (a CPU
    tensor)."""
    power, mel, tb = spectromel(audio, lengths, sr=sr, n_fft=n_fft, hop_length=hop_length,
                                n_mels=n_mels, n_chroma=n_chroma, with_stats=False,
                                with_tuning=with_tuning)
    mask = frame_mask(lengths, hop_length, power.shape[1])
    return power, mask, db_from_mel(mel, mask), tb


def _stat_pair(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, T, C] + [B, T] -> [B, 2C] (means then stds, ref pipeline1.py:220-221)."""
    return torch.cat(masked_mean_std(x, mask, axis=1), dim=-1)


def extract_features_149_batch(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    n_mfcc: int = 20,
    n_chroma: int = 12,
) -> torch.Tensor:
    """audio [B, N] (zero-padded, N a multiple of hop), lengths [B] -> [B, 149].

    The text features are zeros (the reference's transcripts are empty).
    Clips with fewer than 9 valid frames (< 0.26 s) give all-zero vectors,
    as the reference's exception path does (pipeline1.py:237-239)."""
    B = audio.shape[0]
    n_valid = 1 + torch.div(lengths, hop_length, rounding_mode="floor")
    power, stats, tb = spectromel(
        audio, lengths, sr=sr, n_fft=n_fft, hop_length=hop_length,
        n_mels=n_mels, n_mfcc=n_mfcc, n_chroma=n_chroma,
    )
    ch_stats = chroma_stats(power, tb, n_valid, sr=sr, n_fft=n_fft, n_chroma=n_chroma)
    feats = torch.cat(
        [stats.reshape(B, 6 * n_mfcc), ch_stats, audio.new_zeros(B, 5)], dim=-1
    )
    return torch.where((n_valid >= 9)[:, None], feats, 0.0)


def pad_to_bucket(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n; clips beyond the largest bucket are cut to it."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def bucket_groups(lengths, batch_size: int, buckets=DEFAULT_BUCKETS) -> list[tuple[int, list[int]]]:
    """[(N, idxs), ...]: the clips of `lengths` samples grouped by sample
    bucket (pad_to_bucket), the buckets in the order they first come up,
    each bucket's clips in input order and in chunks of batch_size, N the
    bucket."""
    by_bucket: dict[int, list[int]] = {}
    for i, n in enumerate(lengths):
        by_bucket.setdefault(pad_to_bucket(n, buckets), []).append(i)
    return [(b, idxs[s : s + batch_size]) for b, idxs in by_bucket.items()
            for s in range(0, len(idxs), batch_size)]


def fitted_groups(lengths, batch_size: int, step: int, cap: int) -> list[tuple[int, list[int]]]:
    """[(N, idxs), ...]: the clips of `lengths` samples, each cut to `cap`,
    in order of length (a stable sort) and in consecutive chunks of
    batch_size, N the chunk's longest clip rounded up to a multiple of
    `step` (at least one step, at most cap).  So N holds every sample each
    clip of the chunk keeps, and the padding is what the rounding and the
    spread of lengths inside one chunk leave."""
    cut = np.minimum(np.asarray(lengths, np.int64), cap)
    order = np.argsort(cut, kind="stable")
    out = []
    for s in range(0, len(order), batch_size):
        idxs = order[s : s + batch_size].tolist()
        longest = int(cut[idxs].max())
        out.append((min(cap, max(step, -(-longest // step) * step)), idxs))
    return out


class HostStage:
    """A flat float32 host buffer that padded batches are written into and
    uploaded from, grown to the largest batch asked of it and then reused,
    so a batch touches no freshly mapped pages.  Page-locked when `pinned`
    (a batch bound for a CUDA device): the upload is then one DMA from it,
    not a copy through a pageable bounce buffer."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.buf = torch.empty(0, dtype=torch.float32)

    def take(self, rows: int, n: int) -> torch.Tensor:
        """A [rows, n] view of the buffer, holding whatever was last there."""
        if self.buf.numel() < rows * n:
            self.buf = torch.empty(0, dtype=torch.float32)  # free the old block first
            self.buf = torch.empty(rows * n, dtype=torch.float32, pin_memory=self.pinned)
        return self.buf[: rows * n].view(rows, n)


class StagePool:
    """HostStages handed out one a call under a lock, so threads that pad
    at once never share one (the service's handler threads call the corpus
    path); a call that finds none free makes one, and gives it back at its
    end."""

    def __init__(self):
        self.lock = threading.Lock()
        self.free: dict[bool, list[HostStage]] = {False: [], True: []}

    @contextlib.contextmanager
    def checkout(self, pinned: bool):
        with self.lock:
            stage = self.free[pinned].pop() if self.free[pinned] else HostStage(pinned)
        try:
            yield stage
        finally:
            with self.lock:
                self.free[pinned].append(stage)


STAGES = StagePool()


def pad_batch(clips: list[np.ndarray], idxs: list[int], bucket: int, rows: int,
              stage: HostStage) -> tuple[torch.Tensor, np.ndarray]:
    """The clips `idxs`, each cut to `bucket` samples, zero-padded into
    rows 0..len(idxs)-1 of a [rows, bucket] float32 batch in `stage`'s
    memory -> (batch, lengths [rows] int32, 0 for the rows past the clips).
    Every element is written, since the stage holds an earlier batch: each
    row its clip and then zeros, the rows past the clips zeros."""
    batch = stage.take(rows, bucket)
    a = batch.numpy()
    lens = np.zeros(rows, np.int32)
    for j, i in enumerate(idxs):
        y = clips[i][:bucket]
        a[j, : len(y)] = y
        a[j, len(y) :] = 0.0
        lens[j] = len(y)
    a[len(idxs) :] = 0.0
    return batch, lens


def count_batch(owner: str, batch: torch.Tensor, lens: np.ndarray) -> None:
    """The host batch loop's counters for one padded batch of `owner` (the
    profiling module's counters "<owner>.<counter>"): batches, the samples
    sent (pad_samples) and the clips' own (valid_samples), the bytes
    uploaded (the batch and its lengths), and of them the batch's when it
    went from page-locked memory (pinned_bytes)."""
    nbytes = batch.numel() * batch.element_size()
    count(f"{owner}.batches", 1)
    count(f"{owner}.pad_samples", batch.numel())
    count(f"{owner}.valid_samples", int(lens.sum()))
    count(f"{owner}.h2d_bytes", nbytes + lens.nbytes)
    count(f"{owner}.pinned_bytes", nbytes if batch.is_pinned() else 0)


def launch_shards(batch_fn, shards) -> list[torch.Tensor]:
    """`batch_fn` on every shard (shard_batch's (audio, lengths) lists),
    without gradients; nothing is read back."""
    with torch.no_grad():
        return [batch_fn(a, n) for a, n in zip(*shards)]


def gather(outs: list[torch.Tensor]) -> np.ndarray:
    """The shards' outputs read back and joined in mesh order; a mesh of
    one is its shard's read-back, with no joining copy."""
    if len(outs) == 1:
        return outs[0].cpu().numpy()
    return torch.cat([o.cpu() for o in outs]).numpy()


def host_batches(owner: str, clips: list[np.ndarray], groups, batch_fn, mesh,
                 launch_span: str):
    """The host batch loop: for each (N, idxs) of `groups`, the clips
    `idxs` padded into a [rows, N] batch (pad_batch; rows rounded up to
    the mesh's size with zero-length rows) in a stage of STAGES,
    page-locked when any mesh device is CUDA, cut into one contiguous
    shard per device and uploaded (parallel.mesh.shard_batch), `batch_fn
    (audio, lengths)` launched on every shard before any is read back, so
    the devices run at once, and the results gathered in mesh order ->
    yields (idxs, lengths [rows], host output [rows, ...]).  Traced, the
    loop is the span `owner` and each batch `<owner>.batch`, whose leaves
    are pad, h2d, `launch_span`, d2h and what the caller does with the
    yield (count_batch counts it)."""
    pinned = any(d.type == "cuda" for d in mesh)
    with span(owner), STAGES.checkout(pinned) as stage:
        for bucket, chunk in groups:
            with span(f"{owner}.batch"):
                with span(f"{owner}.pad"):
                    rows = -(-len(chunk) // len(mesh)) * len(mesh)
                    batch, lens = pad_batch(clips, chunk, bucket, rows, stage)
                with span(f"{owner}.h2d"):
                    shards = shard_batch(mesh, batch, lens)
                with span(launch_span):
                    outs = launch_shards(batch_fn, shards)
                with span(f"{owner}.d2h"):
                    host_out = gather(outs)
                if tracing():
                    count_batch(owner, batch, lens)
                yield chunk, lens, host_out


def run_bucketed(
    clips: list[np.ndarray],
    batch_fn,
    out_dim: int,
    buckets=DEFAULT_BUCKETS,
    batch_size: int = 256,
    device: torch.device | str = "cuda",
    mesh=None,
) -> np.ndarray:
    """Group clips into batches, run `batch_fn(audio [B, N], lengths [B])
    -> [B, out_dim]` on them over the mesh (host_batches), and restore the
    order.  A `batch_fn` that carries a `frame_stride` (an encoder whose
    output for a clip does not depend on N: models/wavlm.batch_fn_for) gets
    fitted_groups, the clips by length, each batch padded only to its
    longest clip in whole strides; every other gets bucket_groups over
    `buckets`.  The mesh is `mesh`, or every visible GPU for an unindexed
    `cuda` and the one device asked for otherwise
    (parallel.mesh.resolve_mesh); the outputs of the rows that round a
    batch up to the mesh are dropped.  Traced, the call is the span
    `run_bucketed`, each batch's leaves pad, h2d, launch, d2h and
    scatter."""
    mesh = resolve_mesh(mesh, device)
    out = np.zeros((len(clips), out_dim), np.float32)
    step = getattr(batch_fn, "frame_stride", None)
    lengths = [len(y) for y in clips]
    groups = (fitted_groups(lengths, batch_size, step, buckets[-1]) if step
              else bucket_groups(lengths, batch_size, buckets))
    for chunk, _, got in host_batches("run_bucketed", clips, groups, batch_fn, mesh,
                                      "run_bucketed.launch"):
        with span("run_bucketed.scatter"):
            out[chunk] = got[: len(chunk)]
    return out


def batch_extractor_for(feature_cfg):
    """`batch_fn(audio [B, N], lengths [B]) -> [B, D]` for a FeatureConfig:
    the canonical 149-dim contract, or the 334-variant (main.py geometry,
    fixed semantics; its computed length is 286) when the config includes
    spectral contrast or the scalars, or, for an EmbeddingFeatureConfig,
    its encoder's pooled embedding and the text placeholders
    (models/wavlm.batch_fn_for: the weights one copy per device)."""
    encoder = getattr(feature_cfg, "encoder", None)
    if encoder is not None:
        from stutter_tpu_torch.models.wavlm import batch_fn_for

        return batch_fn_for(encoder, feature_cfg.text_feature_len)
    fe = feature_cfg.frontend
    if feature_cfg.include_contrast or feature_cfg.include_scalars:
        from stutter_tpu_torch.ops.frontend334 import extract_features_334_batch as extract
    else:
        extract = extract_features_149_batch

    def batch_fn(audio, lengths):
        return extract(
            audio, lengths, sr=fe.sample_rate, n_fft=fe.n_fft, hop_length=fe.hop_length,
            n_mels=fe.n_mels, n_mfcc=fe.n_mfcc, n_chroma=fe.n_chroma,
        )

    return batch_fn


def extract_features_numpy(
    clips: list[np.ndarray],
    feature_cfg,
    buckets=DEFAULT_BUCKETS,
    batch_size: int = 256,
    device: torch.device | str = "cuda",
    mesh=None,
) -> np.ndarray:
    """Clips -> [n, feature_cfg.total_feature_len] features on `device`'s
    mesh (run_bucketed)."""
    return run_bucketed(clips, batch_extractor_for(feature_cfg), feature_cfg.total_feature_len,
                        buckets, batch_size, device, mesh)


def extract_features_149_numpy(
    clips: list[np.ndarray],
    sr: int = 16000,
    buckets=DEFAULT_BUCKETS,
    batch_size: int = 256,
    device: torch.device | str = "cuda",
    mesh=None,
) -> np.ndarray:
    """The JAX package's name and signature: clips -> [n, 149] features in
    input order (extract_features_numpy with FEATURES_149 at rate `sr`)."""
    cfg = dataclasses.replace(
        FEATURES_149, frontend=dataclasses.replace(FEATURES_149.frontend, sample_rate=sr))
    return extract_features_numpy(clips, cfg, buckets, batch_size, device, mesh)
