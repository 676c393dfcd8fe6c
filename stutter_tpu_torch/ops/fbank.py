"""SeamlessM4T's log-mel filter bank, the input of W2V-BERT 2.0
(models/w2v_bert.py), as batched device ops over zero-padded clips.

The equations are SeamlessM4TFeatureExtractor's (transformers'
feature_extraction_seamless_m4t.py, its defaults), clip by clip:

  * the waveform x 2^15 (Kaldi's 16-bit scale);
  * frames of 400 samples at a hop of 160, not centred: 1 + (n - 400) // 160
    of them for n >= 400 samples, none below;
  * per frame: its mean removed, pre-emphasis 0.97 (y[0] = 0.03 x[0],
    y[t] = x[t] - 0.97 x[t - 1]), the povey window (Hann^0.85, not
    periodic), zero-padded to 512;
  * the power spectrum, 80 Kaldi-scale mel filters over 20-8000 Hz,
    triangular in mel space, and the log with a floor of 1.1920929e-7;
  * each mel bin to zero mean and unit variance over the clip's own frames
    (variance with ddof 1, plus 1e-7);
  * an odd last frame dropped, then each pair of frames (2t, 2t + 1) side
    by side: [frames // 2, 160] at 50 Hz.

Batched, every clip's frames read only its own samples and its
normalisation only its own frames, so a clip's features are the same alone
and inside a padded batch; the rows past a clip's frames hold whatever the
padding gives and are the caller's to mask.  The FFT is torch.fft (cuFFT on
the card); the filters and the window are built once a device in float64,
as the extractor builds them, and used in float32.

Beside it, Parakeet's log-mel (`parakeet_features`, the input of
models/parakeet.py), ParakeetFeatureExtractor's equations
(feature_extraction_parakeet.py, its defaults), clip by clip:

  * pre-emphasis 0.97 on the waveform (y[0] = x[0], y[t] = x[t] - 0.97
    x[t - 1]), zero past the clip's samples;
  * torch.stft's frames, centred with 256 zeros on each side: 1 + N // 160
    of them, each 512 samples under a symmetric 400-point Hann window
    centred in them;
  * the power spectrum, 80 slaney-normalised mel filters over 0-8000 Hz
    (ops/filterbanks.mel_filterbank, librosa's), and log(x + 2^-24);
  * each bin normalised over the clip's first L // 160 frames, ddof 1:
    (x - mean) / (std + 1e-5), and zero past them.

It shares the rfft, the mel product and the masked moments with
SeamlessM4T's recipe; a frame reads only its clip's samples (the padding
past them is zeroed), so a clip's features are the same alone and inside
a padded batch.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from stutter_tpu_torch.ops.filterbanks import mel_filterbank

SAMPLE_RATE = 16000
SCALE = 2.0**15
FRAME = 400
HOP = 160
N_FFT = 512
N_MELS = 80
F_MIN = 20.0
PREEMPHASIS = 0.97
MEL_FLOOR = 1.192092955078125e-07
NORM_EPS = 1e-7
STRIDE = 2  # frames stacked into one row
# one row a STRIDE frames: the samples of a row, which fitted batches pad to
ROW_SAMPLES = STRIDE * HOP


def n_frames(lengths):
    """Fbank frames of clips of `lengths` samples (an int or an integer
    tensor): 1 + (n - 400) // 160, and 0 below 400 samples."""
    if isinstance(lengths, torch.Tensor):
        return torch.where(lengths >= FRAME, 1 + (lengths - FRAME) // HOP, 0)
    return 1 + (lengths - FRAME) // HOP if lengths >= FRAME else 0


def frame_lengths(lengths):
    """Encoder frames (stacked pairs) of clips of `lengths` samples:
    n_frames // 2."""
    return n_frames(lengths) // STRIDE


def _kaldi_mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


@functools.lru_cache(maxsize=8)
def mel_filters(device) -> torch.Tensor:
    """[257, 80] float32: mel_filter_bank(257, 80, 20, 8000, 16000,
    mel_scale "kaldi", triangularize_in_mel_space) as the extractor builds
    it, in float64."""
    edges = np.linspace(_kaldi_mel(F_MIN), _kaldi_mel(SAMPLE_RATE / 2), N_MELS + 2)
    bins = _kaldi_mel(SAMPLE_RATE / N_FFT * np.arange(N_FFT // 2 + 1))
    slopes = edges[None, :] - bins[:, None]
    down = -slopes[:, :-2] / np.diff(edges)[:-1]
    up = slopes[:, 2:] / np.diff(edges)[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return torch.as_tensor(fb, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=8)
def povey_window(device) -> torch.Tensor:
    """[400] float32: np.hanning(400) ** 0.85."""
    n = np.arange(FRAME)
    w = (0.5 - 0.5 * np.cos(2.0 * math.pi * n / (FRAME - 1))) ** 0.85
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def _mel_power(frames: torch.Tensor, window: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """Frames [B, F, w] under `window` [w], zero-padded to N_FFT -> the mel
    power [B, F, n_mels]: |rfft|^2 through the filters [257, n_mels]."""
    spec = torch.fft.rfft(F.pad(frames * window, (0, N_FFT - frames.shape[-1])))
    return torch.view_as_real(spec).pow(2).sum(-1) @ filters


def log_mel(audio: torch.Tensor) -> torch.Tensor:
    """audio [B, N] -> the log-mel frames [B, n_frames(N), 80] of every
    frame of the padded batch (frame f reads samples 160 f .. 160 f + 399
    only)."""
    frames = (audio * SCALE).unfold(1, FRAME, HOP)  # [B, F, 400]
    frames = frames - frames.mean(-1, keepdim=True)
    frames = torch.cat([frames[..., :1] * (1.0 - PREEMPHASIS),
                        frames[..., 1:] - PREEMPHASIS * frames[..., :-1]], dim=-1)
    mel = _mel_power(frames, povey_window(audio.device), mel_filters(audio.device))
    return torch.log(mel.clamp(min=MEL_FLOOR))


def _moments(feats: torch.Tensor, n: torch.Tensor) -> tuple:
    """(valid [B, F, 1], mean [B, 1, M], variance with ddof 1 [B, 1, M]) of
    each clip's bins over its first n[b] frames."""
    valid = (torch.arange(feats.shape[1], device=feats.device)[None, :] < n[:, None])[..., None]
    count = n.to(feats.dtype)[:, None, None]
    mean = torch.where(valid, feats, 0.0).sum(1, keepdim=True) / count.clamp(min=1)
    var = torch.where(valid, (feats - mean) ** 2, 0.0).sum(1, keepdim=True) / (count - 1).clamp(min=1)
    return valid, mean, var


def normalise(feats: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Each clip's mel bins to zero mean and unit variance over its first
    n[b] frames (ddof 1, eps NORM_EPS); the frames past them likewise
    shifted and scaled."""
    _, mean, var = _moments(feats, n)
    return (feats - mean) / torch.sqrt(var + NORM_EPS)


def stack_pairs(feats: torch.Tensor) -> torch.Tensor:
    """[B, F, 80] -> [B, F // 2, 160]: frames 2t and 2t + 1 side by side, an
    odd last frame dropped."""
    B, n, m = feats.shape
    T = n // STRIDE
    return feats[:, : T * STRIDE].reshape(B, T, STRIDE * m)


def features(audio: torch.Tensor, lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """audio [B, N] (zero-padded), lengths [B] samples -> (the stacked,
    normalised fbank [B, frame_lengths(N), 160], each clip's rows
    frame_lengths(lengths) [B])."""
    n = n_frames(lengths)
    return stack_pairs(normalise(log_mel(audio), n)), n // STRIDE


# ------------------------------------------------- Parakeet's log-mel

PK_WIN = 400  # the Hann window's samples, centred in N_FFT
PK_LOG_GUARD = 2.0**-24
PK_NORM_EPS = 1e-5


def parakeet_n_frames(lengths):
    """Parakeet's valid log-mel frames of clips of `lengths` samples (an
    int or an integer tensor): L // 160."""
    return lengths // HOP


def parakeet_frame_lengths(lengths, reductions: int = 3):
    """Encoder frames of clips of `lengths` samples: L // 160, then the
    stem's stride-2 convs (kernel 3, padding 1) each taking T to
    floor((T - 1) / 2) + 1 = (T + 1) // 2 (0 stays 0)."""
    t = parakeet_n_frames(lengths)
    for _ in range(reductions):
        t = (t + 1) // 2
    return t


@functools.lru_cache(maxsize=8)
def slaney_filters(device) -> torch.Tensor:
    """[257, 80] float32: librosa.filters.mel(sr=16000, n_fft=512,
    n_mels=80, fmin=0, fmax=8000, norm="slaney"), transposed."""
    fb = mel_filterbank(SAMPLE_RATE, N_FFT, N_MELS, 0.0, SAMPLE_RATE / 2)
    return torch.as_tensor(fb.T.copy(), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=8)
def hann_window_centred(device) -> torch.Tensor:
    """[512] float32: torch.hann_window(400, periodic=False) with 56 zeros
    on each side, as torch.stft centres a shorter window."""
    w = torch.hann_window(PK_WIN, periodic=False, dtype=torch.float64)
    side = (N_FFT - PK_WIN) // 2
    return F.pad(w, (side, N_FFT - PK_WIN - side)).to(torch.float32).to(device)


def parakeet_log_mel(audio: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """audio [B, N] (zero-padded), lengths [B] samples -> the log-mel
    frames [B, 1 + N // 160, 80] of the padded batch: each clip
    pre-emphasised and zeroed past its samples, then centred STFT frames."""
    n = audio.shape[1]
    x = torch.cat([audio[:, :1], audio[:, 1:] - PREEMPHASIS * audio[:, :-1]], dim=1)
    x = torch.where(torch.arange(n, device=audio.device)[None, :] < lengths[:, None], x, 0.0)
    frames = F.pad(x, (N_FFT // 2, N_FFT // 2)).unfold(1, N_FFT, HOP)  # [B, 1 + N // 160, 512]
    mel = _mel_power(frames, hann_window_centred(audio.device), slaney_filters(audio.device))
    return torch.log(mel + PK_LOG_GUARD)


def parakeet_normalise(feats: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Each clip's bins over its first n[b] frames: (x - mean) / (std +
    PK_NORM_EPS), std with ddof 1; the frames past them zero."""
    valid, mean, var = _moments(feats, n)
    return torch.where(valid, (feats - mean) / (torch.sqrt(var) + PK_NORM_EPS), 0.0)


def parakeet_features(audio: torch.Tensor, lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """audio [B, N] (zero-padded), lengths [B] samples -> (the normalised
    log-mel [B, 1 + N // 160, 80], zero past each clip's frames, and those
    frames parakeet_n_frames(lengths) [B])."""
    n = parakeet_n_frames(lengths)
    return parakeet_normalise(parakeet_log_mel(audio, lengths), n), n
