"""stutter_tpu_torch: the PyTorch + CUDA (Hopper) port of stutter_tpu.

The JAX package `stutter_tpu` stays the reference; this package serves the
same artifacts on an NVIDIA H100.  Its serving path is the reference's
upload-and-predict flow: decode -> resample -> spectral-gate denoise ->
features (149-dim, or the 286-dim variant) -> scaler -> seed-averaged MLP
softmax, or log-mel / MFCC frames -> the CNN, CNN-BiLSTM and transformer
heads -> their weighted vote (the headline model), per clip, per
micro-batch, over a stream of windows or behind the HTTP service; its
corpus path denoises the corpus with per-file QC metrics (`preprocess`)
and builds the feature cache (`extract_corpus`); its training path trains
the feature MLP (engines A and B) and the sequence heads' folds x seeds
grids, their nested weighted vote and the servable quint (`run_cv`).  The
Pallas kernels of these paths are hand-written CUDA here (`csrc/*.cu`),
built with nvcc at first use; each has a plain PyTorch version that runs
for CPU tensors.  Nothing in this package imports JAX or the JAX package:
the configuration, corpus, cache, WAV / mp3, decoder-hook, filterbank and
stage-timer modules it shares with `stutter_tpu` are its own copies.

Public surface (lazily imported; `import stutter_tpu_torch as stt`):

  stt.extract_features_149_batch / extract_features_334_batch
  stt.extract_features_numpy / extract_features_149_numpy    the front end
  stt.denoise_clips / stt.denoise_batch                      spectral gate
  stt.preprocess / stt.extract_corpus                        the corpus path
  stt.run_cv / stt.run_before_after                          training drivers
  stt.fit_mlp / stt.cross_validate_mlp                       the MLP's training
  stt.cross_validate_seq / stt.nested_weighted_vote          seq heads + stacking
  stt.Predictor / stt.SeqPredictor / stt.EnsemblePredictor  serving: the MLP,
                                                             a head, the vote
  stt.serve                                                  the HTTP service
  stt.SeedMLP                                                the MLP head
  stt.StandardScaler / stt.LabelEncoder                      numpy artifacts
"""

__version__ = "0.1.0"

_LAZY = {
    "extract_features_149_batch": ("stutter_tpu_torch.ops.frontend", "extract_features_149_batch"),
    "extract_features_334_batch": ("stutter_tpu_torch.ops.frontend334",
                                   "extract_features_334_batch"),
    "extract_features_numpy": ("stutter_tpu_torch.ops.frontend", "extract_features_numpy"),
    "extract_features_149_numpy": ("stutter_tpu_torch.ops.frontend", "extract_features_149_numpy"),
    "denoise_clips": ("stutter_tpu_torch.denoise", "denoise_clips"),
    "denoise_batch": ("stutter_tpu_torch.denoise", "denoise_batch"),
    "preprocess": ("stutter_tpu_torch.pipeline", "preprocess"),
    "extract_corpus": ("stutter_tpu_torch.pipeline", "extract_corpus"),
    "run_cv": ("stutter_tpu_torch.pipeline", "run_cv"),
    "run_before_after": ("stutter_tpu_torch.pipeline", "run_before_after"),
    "fit_mlp": ("stutter_tpu_torch.train.trainer", "fit_mlp"),
    "cross_validate_mlp": ("stutter_tpu_torch.train.trainer", "cross_validate_mlp"),
    "cross_validate_seq": ("stutter_tpu_torch.train.seq_pipeline", "cross_validate_seq"),
    "nested_weighted_vote": ("stutter_tpu_torch.train.ensemble", "nested_weighted_vote"),
    "Predictor": ("stutter_tpu_torch.infer", "Predictor"),
    "SeqPredictor": ("stutter_tpu_torch.infer", "SeqPredictor"),
    "EnsemblePredictor": ("stutter_tpu_torch.infer", "EnsemblePredictor"),
    "serve": ("stutter_tpu_torch.serve", "serve"),
    "SeedMLP": ("stutter_tpu_torch.models.mlp", "SeedMLP"),
    "StandardScaler": ("stutter_tpu_torch.models.scaler", "StandardScaler"),
    "LabelEncoder": ("stutter_tpu_torch.models.scaler", "LabelEncoder"),
}

__all__ = ["__version__", *_LAZY]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'stutter_tpu_torch' has no attribute {name!r}")
