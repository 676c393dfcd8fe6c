"""Typed configuration of the port (counterpart of stutter_tpu/config.py).

The same frozen dataclasses, field for field and default for default, so a
configuration means the same thing to both packages; the port keeps its
own copy and never imports the JAX package's.

Two frontend variants exist in the reference:
  * 149-dim (canonical; pipeline1.py:84-86, main1.py): 20 MFCC, librosa default
    FFT geometry (n_fft=2048, hop=512), + chroma(12) stats + 5 text dims.
  * 334-dim (main.py:628-630): 40 MFCC, n_fft=512, hop=256, + chroma + spectral
    contrast + zcr/rms/centroid scalars + 5 text dims (286 computed; the
    reference's extractor is broken at runtime, main.py:753, and the intended,
    fixed semantics are implemented).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """DSP front-end geometry (ref: pipeline1.py:77-86, main.py:621-630)."""

    sample_rate: int = 16000
    n_fft: int = 2048
    hop_length: int = 512
    win_length: int | None = None  # defaults to n_fft
    n_mels: int = 128
    n_mfcc: int = 20
    n_chroma: int = 12
    fmin: float = 0.0
    fmax: float | None = None  # defaults to sr/2
    # librosa >= 0.10 stft default; older versions used "reflect".
    pad_mode: str = "constant"
    center: bool = True
    # power_to_db semantics (librosa defaults used by mfcc)
    amin: float = 1e-10
    top_db: float = 80.0
    # Savitzky-Golay delta (librosa.feature.delta defaults)
    delta_width: int = 9
    # chroma tuning estimation (librosa estimate_tuning defaults)
    tuning_resolution: float = 0.01
    pip_fmin: float = 150.0
    pip_fmax: float = 4000.0
    pip_threshold: float = 0.1
    # spectral contrast (334-dim variant; librosa defaults)
    contrast_fmin: float = 200.0
    contrast_n_bands: int = 6
    contrast_quantile: float = 0.02

    @property
    def effective_win_length(self) -> int:
        return self.win_length if self.win_length is not None else self.n_fft

    @property
    def effective_fmax(self) -> float:
        return self.fmax if self.fmax is not None else self.sample_rate / 2.0

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, n_samples: int) -> int:
        """Frame count for a centered STFT (librosa: 1 + n // hop)."""
        if self.center:
            return 1 + n_samples // self.hop_length
        return 1 + (n_samples - self.n_fft) // self.hop_length


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Feature-vector layout (ref: pipeline1.py:84-86 / main.py:628-630)."""

    frontend: FrontendConfig = FrontendConfig()
    include_contrast: bool = False  # True for the 334-dim variant
    include_scalars: bool = False  # zcr/rms/centroid (334-dim variant)
    text_feature_len: int = 5

    @property
    def audio_feature_len(self) -> int:
        n = (self.frontend.n_mfcc * 2) * 3 + self.frontend.n_chroma * 2
        if self.include_contrast:
            n += (self.frontend.contrast_n_bands + 1) * 2
        if self.include_scalars:
            n += 3
        return n

    @property
    def total_feature_len(self) -> int:
        return self.audio_feature_len + self.text_feature_len

    def feature_names(self) -> list[str]:
        """Deterministic feature names (ref: pipeline1.py:270-286, main.py:781-793)."""
        names: list[str] = []
        for pref in ["mfcc", "delta", "delta2"]:
            names += [f"{pref}_mean_{i}" for i in range(self.frontend.n_mfcc)]
            names += [f"{pref}_std_{i}" for i in range(self.frontend.n_mfcc)]
        names += [f"chroma_mean_{i}" for i in range(self.frontend.n_chroma)]
        names += [f"chroma_std_{i}" for i in range(self.frontend.n_chroma)]
        if self.include_contrast:
            nb = self.frontend.contrast_n_bands + 1
            names += [f"contrast_mean_{i}" for i in range(nb)]
            names += [f"contrast_std_{i}" for i in range(nb)]
        if self.include_scalars:
            names += ["zcr", "rms", "centroid"]
        names += [
            "transcript_length",
            "word_count",
            "repetition_count",
            "repetition_ratio",
            "unique_ratio",
        ]
        if len(names) > self.total_feature_len:
            names = names[: self.total_feature_len]
        elif len(names) < self.total_feature_len:
            names += [f"pad_{i}" for i in range(self.total_feature_len - len(names))]
        return names


# The two reference variants, pre-built.
FEATURES_149 = FeatureConfig(frontend=FrontendConfig())
FEATURES_334 = FeatureConfig(
    frontend=FrontendConfig(n_mfcc=40, n_fft=512, hop_length=256),
    include_contrast=True,
    include_scalars=True,
)


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """A WavLM encoder (models/wavlm.py), its widths under the names of
    microsoft/wavlm-large's config.json (the defaults: WavLM-Large, with
    feat_extract_norm "layer", conv_bias false, do_stable_layer_norm true).
    The weights are the .npz `weights` (persist.save_wavlm, the checkpoint's
    parameter names) or, without one, drawn from `seed` on the device.  On
    a CUDA device the attention core is one kernel (csrc/gated_attention.cu)
    that takes a head width hidden_size / num_attention_heads of 64 only,
    as both published WavLMs have; another raises ValueError there (the
    CPU runs any width)."""

    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    seed: int = 0
    weights: str | None = None


@dataclasses.dataclass(frozen=True)
class W2VBertConfig:
    """A W2V-BERT 2.0 encoder (models/w2v_bert.py: SeamlessM4T's 80-mel
    Kaldi fbank, frame pairs stacked to 160 dims, then Conformer layers),
    its widths under the names of facebook/w2v-bert-2.0's config.json (the
    defaults: the published model, relative_key positions, no adapter).
    The weights are the .npz `weights` (persist.save_wavlm, the
    checkpoint's parameter names) or, without one, drawn from `seed` on the
    device.  On a CUDA device the attention core is the relative-key mode
    of csrc/gated_attention.cu, which takes a head width hidden_size /
    num_attention_heads of 64 and at most 80 distances (left + right + 1);
    another raises ValueError there (the CPU runs any)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    conv_depthwise_kernel_size: int = 31
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    layer_norm_eps: float = 1e-5
    seed: int = 0
    weights: str | None = None


@dataclasses.dataclass(frozen=True)
class ParakeetConfig:
    """A Parakeet-CTC FastConformer encoder (models/parakeet.py: a slaney
    log-mel of 80 bins at 100 Hz, an 8x conv-subsampling stem, then
    Conformer layers with Transformer-XL relative attention), its widths
    under the names of nvidia/parakeet-ctc-1.1b's config.json (the
    defaults: the published encoder, no CTC head; `scale_input` is
    transformers' default, which no source at hand contradicts).  The
    weights are the .npz `weights` (persist.save_wavlm, the checkpoint's
    parameter names and BatchNorm's running statistics) or, without one,
    drawn from `seed` on the device.  On a CUDA device the attention core
    is the third mode of csrc/gated_attention.cu, which takes a head width
    hidden_size / num_attention_heads of 128, and the conv module's core
    csrc/glu_depthwise.cu's centred instantiation, which takes 9 taps;
    another raises ValueError there (the CPU runs any)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 42
    num_attention_heads: int = 8
    intermediate_size: int = 4096
    conv_kernel_size: int = 9
    subsampling_factor: int = 8
    subsampling_conv_channels: int = 256
    subsampling_conv_kernel_size: int = 3
    subsampling_conv_stride: int = 2
    num_mel_bins: int = 80
    max_position_embeddings: int = 5000
    scale_input: bool = True
    seed: int = 0
    weights: str | None = None


@dataclasses.dataclass(frozen=True)
class EmbeddingFeatureConfig(FeatureConfig):
    """Features that are a speech encoder's pooled embedding (the masked
    mean of its last hidden state over a clip's frames) followed by the
    text placeholders: 1024 + 5 for WavLM-Large, W2V-BERT 2.0 and
    Parakeet-CTC-1.1B.  The
    front end's sample_rate is the encoder's input rate; its other fields
    go unused."""

    encoder: WavLMConfig | W2VBertConfig | ParakeetConfig = WavLMConfig()

    @property
    def audio_feature_len(self) -> int:
        return self.encoder.hidden_size

    def feature_names(self) -> list[str]:
        return [f"embed_{i}" for i in range(self.encoder.hidden_size)] + [
            "transcript_length", "word_count", "repetition_count", "repetition_ratio",
            "unique_ratio"][: self.text_feature_len]


FEATURES_WAVLM = EmbeddingFeatureConfig()
FEATURES_W2V_BERT = EmbeddingFeatureConfig(encoder=W2VBertConfig())
FEATURES_PARAKEET = EmbeddingFeatureConfig(encoder=ParakeetConfig())


@dataclasses.dataclass(frozen=True)
class DenoiseConfig:
    """Non-stationary spectral-gating denoiser (noisereduce-equivalent).

    Ref call sites: pipeline1.py:140 (prop_decrease=1.0 default),
    main.py:657 / main1.py:605 (prop_decrease=0.8).
    Defaults mirror noisereduce.SpectralGateNonStationary.
    """

    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    prop_decrease: float = 1.0
    time_constant_s: float = 2.0
    freq_mask_smooth_hz: float = 500.0
    time_mask_smooth_ms: float = 50.0
    thresh_n_mult_nonstationary: float = 2.0
    sigmoid_slope_nonstationary: float = 10.0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Filesystem layout contract (ref: pipeline1.py:29-35)."""

    data_dir: str = "segrigated_samples"
    output_dir: str = "output_results"
    cache_dir: str = "cache_features"
    clear_dir: str = "clear_audio"
    audio_exts: Tuple[str, ...] = (".wav", ".mp3", ".flac", ".m4a", ".ogg")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training / evaluation protocol (ref: pipeline1.py:476-499, main.py:892-913)."""

    seed: int = 42
    test_size: float = 0.2
    n_folds: int = 5
    # MLP head (ref main.py:902-905)
    mlp_hidden: Tuple[int, ...] = (256, 128, 64)
    mlp_alpha: float = 1e-4
    mlp_max_iter: int = 1200
    batch_size: int = 128
    learning_rate: float = 1e-3


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    features: FeatureConfig = FEATURES_149
    denoise: DenoiseConfig = DenoiseConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
