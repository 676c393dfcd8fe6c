"""The corpus path (counterpart of the corpus half of stutter_tpu/pipeline.py):

  * preprocess():      denoise every corpus clip into clear_audio/ and write
                       the per-file QC report per_file_analysis.csv
                       (ref pipeline1.py:371-424, main.py:842-867)
  * extract_corpus():  the feature cache, both variants
                       (ref pipeline1.py:429-456, main.py:665-672)

Both run on an explicit device: the gate and spectromel kernels for
`cuda`, their plain versions for `cpu`.  They write what the JAX package
writes -- the same clear_audio/ files, the same cache_features/ names
(`cache.FeatureCache`, the port's copy of the JAX package's, with the
`_d286` namespace of the 286-dim variant) and the same
per_file_analysis.csv columns -- so either package reads the other's
workspace.

Unlike the JAX package, a device or kernel error is never caught: an
undecodable file degrades its own row, and a malformed clip is left raw by
the denoiser, but a kernel that fails to build or launch raises through
both entry points.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch

from stutter_tpu_torch.cache import FeatureCache
from stutter_tpu_torch.config import DenoiseConfig, PipelineConfig
from stutter_tpu_torch.data import label_of, list_audio_files
from stutter_tpu_torch.denoise import denoise_clips
from stutter_tpu_torch.evals import write_csv
from stutter_tpu_torch.infer import resolve_device
from stutter_tpu_torch.io.decode import read_audio, to_rate
from stutter_tpu_torch.io.wav import load_mono, write_wav
from stutter_tpu_torch.ops.frontend import DEFAULT_BUCKETS, batch_extractor_for, run_bucketed
from stutter_tpu_torch.utils.profiling import StageTimer

log = logging.getLogger("stutter_tpu_torch.pipeline")

QC_KEYS = ("snr_db", "spectral_flatness", "hf_energy_ratio")


def setup_logging(output_dir: str) -> None:
    """File logging to output_dir/pipeline.log, like the reference (main.py:573-577)."""
    os.makedirs(output_dir, exist_ok=True)
    logging.basicConfig(
        filename=os.path.join(output_dir, "pipeline.log"),
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
    )


def _load_clip(path: str, sr: int, decoder=None,
               device: torch.device | str = "cpu") -> np.ndarray | None:
    """The clip at `sr`, or None when no decoder reads the file
    (ref pipeline1.py:100-106); resampling runs on `device`."""
    try:
        y, file_sr = read_audio(path, sr, decoder)
    except Exception as e:  # noqa: BLE001 - an undecodable file degrades its row
        log.error("load_audio fail %s: %s", path, e)
        return None
    return to_rate(y, file_sr, sr, device)


def _denoise_with_fallback(
    clips: list, cfg: DenoiseConfig, device: torch.device | str = "cpu"
) -> list[np.ndarray | None]:
    """Denoise a batch of clips; a clip that is not 1-D float audio is left
    out and returned as None (the caller keeps it raw, ref main.py:662-663).
    Errors of the denoiser itself -- a kernel that fails to build or
    launch -- propagate."""
    out: list[np.ndarray | None] = [None] * len(clips)
    good: list[tuple[int, np.ndarray]] = []
    for i, y in enumerate(clips):
        try:
            arr = np.asarray(y, np.float32)
            if arr.ndim != 1:
                raise ValueError(f"clip of shape {arr.shape} is not 1-D")
        except (TypeError, ValueError) as e:
            log.error("denoise skipped for clip %d (%s); falling back to raw", i, e)
            continue
        good.append((i, arr))
    if good:
        cleaned = denoise_clips([y for _, y in good], cfg, device=device)
        for (i, _), y in zip(good, cleaned):
            out[i] = y
    return out


def preprocess(
    root: str = ".", cfg: PipelineConfig = PipelineConfig(), decoder=None, *,
    device: torch.device | str,
) -> list[dict]:
    """Clean every corpus clip (cached in clear_audio/) and compute the QC
    metrics before and after -> per_file_analysis.csv rows, returned."""
    from stutter_tpu_torch.ops.qc import qc_metrics_batch

    dev = resolve_device(device)
    data = cfg.data
    sr = cfg.features.frontend.sample_rate
    clear_dir = os.path.join(root, data.clear_dir)
    out_dir = os.path.join(root, data.output_dir)
    os.makedirs(clear_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)

    timer = StageTimer()
    files = list_audio_files(os.path.join(root, data.data_dir), data.audio_exts)
    pending: list[tuple[str, str, np.ndarray]] = []
    with timer.stage("decode_raw"):
        for f in files:
            y = _load_clip(f, sr, decoder, dev)
            if y is not None:
                pending.append((f, label_of(f), y))
    skipped = len(files) - len(pending)

    def qc_of(clips: list[np.ndarray]) -> dict[str, np.ndarray]:
        def qc_stack(a, n):
            m = qc_metrics_batch(a, n, sr)
            return torch.stack([m[k] for k in QC_KEYS], dim=-1)

        vals = run_bucketed(clips, qc_stack, len(QC_KEYS), device=dev)
        return {k: vals[:, j] for j, k in enumerate(QC_KEYS)}

    raw_clips = [y for _, _, y in pending]
    # clean, reusing clear_audio/ entries (ref pipeline1.py:131-135)
    cleaned_clips: list[np.ndarray | None] = []
    to_denoise_idx = []
    for i, (f, _, _) in enumerate(pending):
        cached = os.path.join(clear_dir, Path(f).stem + ".wav")
        if os.path.exists(cached):
            cleaned_clips.append(_load_clip(cached, sr, device=dev))
        else:
            cleaned_clips.append(None)
            to_denoise_idx.append(i)
    if to_denoise_idx:
        with timer.stage("denoise"):
            denoised = _denoise_with_fallback([raw_clips[i] for i in to_denoise_idx],
                                              cfg.denoise, dev)
        for i, y in zip(to_denoise_idx, denoised):
            if y is None:
                cleaned_clips[i] = raw_clips[i]  # per-file degrade (ref main.py:662-663)
                continue
            out_path = os.path.join(clear_dir, Path(pending[i][0]).stem + ".wav")
            write_wav(out_path, y, sr)
            cleaned_clips[i], _ = load_mono(out_path, sr=sr)  # the 16-bit round trip

    with timer.stage("qc_before"):
        qc_before = qc_of(raw_clips)
    with timer.stage("qc_after"):
        qc_after = qc_of([c if c is not None else r for c, r in zip(cleaned_clips, raw_clips)])

    rows = []
    for i, (f, label, y) in enumerate(pending):
        rows.append({
            "file": os.path.basename(f),
            "label": label,
            "duration_sec": len(y) / sr,
            "snr_before_db": qc_before["snr_db"][i],
            "snr_after_db": qc_after["snr_db"][i],
            "spectral_flatness_before": qc_before["spectral_flatness"][i],
            "spectral_flatness_after": qc_after["spectral_flatness"][i],
            "hf_energy_ratio_before": qc_before["hf_energy_ratio"][i],
            "hf_energy_ratio_after": qc_after["hf_energy_ratio"][i],
            "transcript": "",
        })
    log.info("preprocessed %d files, skipped %d", len(rows), skipped)
    timer.log_report()
    write_csv(
        os.path.join(out_dir, "per_file_analysis.csv"),
        list(rows[0].keys()) if rows else ["file"],
        [list(r.values()) for r in rows],
    )
    return rows


def extract_corpus(
    root: str = ".",
    cfg: PipelineConfig = PipelineConfig(),
    suffix: str = "clean",
    decoder=None,
    *,
    device: torch.device | str,
) -> tuple[np.ndarray, list[str], list[str], np.ndarray]:
    """Feature extraction over the corpus with cache reuse, for the variant
    of cfg.features (each variant has its own cache namespace).

    suffix='clean' reads clear_audio/<stem>.wav; suffix='raw' decodes the
    original files, with `decoder` (path, sr -> float32 PCM) for formats the
    WAV readers do not take.  Returns (X [n, D], labels, files, ok [n]):
    rows whose audio no decoder reads are zero with ok=False."""
    from stutter_tpu_torch.io.native import BatchPrefetcher

    dev = resolve_device(device)
    data = cfg.data
    sr = cfg.features.frontend.sample_rate
    dim = cfg.features.total_feature_len
    files = list_audio_files(os.path.join(root, data.data_dir), data.audio_exts)
    cache = FeatureCache(os.path.join(root, data.cache_dir), dim)

    labels = [label_of(f) for f in files]
    X = np.zeros((len(files), dim), np.float32)
    ok = np.zeros(len(files), bool)
    miss_rows: list[int] = []
    miss_paths: list[str] = []
    for i, f in enumerate(files):
        cached = cache.load(f, suffix)
        if cached is not None and cached.shape == (dim,):
            X[i] = cached
            ok[i] = True
            continue
        miss_rows.append(i)
        miss_paths.append(os.path.join(root, data.clear_dir, Path(f).stem + ".wav")
                          if suffix == "clean" else f)
    if miss_rows:
        timer = StageTimer()
        fn = batch_extractor_for(cfg.features)
        prefetch = BatchPrefetcher(miss_paths, DEFAULT_BUCKETS[-1], batch_size=256, sr=sr,
                                   decoder=decoder, device=dev)
        pos = 0
        for audio, lens, chunk in prefetch:
            rows = miss_rows[pos : pos + len(chunk)]
            pos += len(chunk)
            keep = [(i, audio[j, : lens[j]]) for j, i in enumerate(rows) if lens[j] > 0]
            if not keep:
                continue
            with timer.stage("extract"):
                feats = run_bucketed([y for _, y in keep], fn, dim, device=dev)
            with timer.stage("cache_store"):
                for (i, _), v in zip(keep, feats):
                    X[i] = v
                    ok[i] = True
                    cache.store(files[i], suffix, v)
        timer.log_report()
    n_failed = int((~ok).sum())
    if n_failed:
        log.warning("extract_corpus(%s): %d/%d rows failed decode and are zero/ok=False",
                    suffix, n_failed, len(files))
    return X, labels, files, ok
