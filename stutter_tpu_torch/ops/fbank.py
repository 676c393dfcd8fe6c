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
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

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


def log_mel(audio: torch.Tensor) -> torch.Tensor:
    """audio [B, N] -> the log-mel frames [B, n_frames(N), 80] of every
    frame of the padded batch (frame f reads samples 160 f .. 160 f + 399
    only)."""
    frames = (audio * SCALE).unfold(1, FRAME, HOP)  # [B, F, 400]
    frames = frames - frames.mean(-1, keepdim=True)
    frames = torch.cat([frames[..., :1] * (1.0 - PREEMPHASIS),
                        frames[..., 1:] - PREEMPHASIS * frames[..., :-1]], dim=-1)
    spec = torch.fft.rfft(F.pad(frames * povey_window(audio.device), (0, N_FFT - FRAME)))
    power = torch.view_as_real(spec).pow(2).sum(-1)  # [B, F, 257]
    return torch.log((power @ mel_filters(audio.device)).clamp(min=MEL_FLOOR))


def normalise(feats: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Each clip's mel bins to zero mean and unit variance over its first
    n[b] frames (ddof 1, eps NORM_EPS); the frames past them likewise
    shifted and scaled."""
    valid = (torch.arange(feats.shape[1], device=feats.device)[None, :] < n[:, None])[..., None]
    count = n.to(feats.dtype)[:, None, None]
    mean = torch.where(valid, feats, 0.0).sum(1, keepdim=True) / count.clamp(min=1)
    var = torch.where(valid, (feats - mean) ** 2, 0.0).sum(1, keepdim=True) / (count - 1).clamp(min=1)
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
