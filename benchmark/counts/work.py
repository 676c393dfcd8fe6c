"""Operations and bytes of each stage, counted from the algorithm's own
shapes and never from the launches the port makes: a later change may
fuse, split or rename kernels and the yardstick still reads the same work.

Conventions (one FP32 operation = one add or one multiply):
  * a real FFT of n points: 2.5 n log2 n operations;
  * bytes: the stage's inputs read once and its outputs written once,
    float32 (4 bytes) unless said otherwise -- never what an
    implementation reads twice or keeps as scratch;
  * a clip's frames: a centred STFT of hop h over n samples has
    1 + n // h frames.
The sizes a count needs (clip length, configuration) are arguments;
`bound_s` turns (operations, bytes) into the least time on the peaks of
`peaks.py`.
"""

from __future__ import annotations

import math

from .peaks import FP32_FLOPS, HBM_BYTES_PER_S

F32 = 4


def fft_ops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def bound_s(ops: float, n_bytes: float) -> float:
    """The least time for the work: the operations at the FP32 peak or the
    bytes at the HBM rate, whichever is longer."""
    return max(ops / FP32_FLOPS, n_bytes / HBM_BYTES_PER_S)


def gate(n: int, cfg: dict) -> tuple[float, float]:
    """noisereduce's non-stationary gate on one clip of n samples, padded
    by `pad` zeros each side (the algorithm's own chunk padding), counting
    what the clip needs and not what the padding would cost:
      * every frame, the pad's too: the bidirectional IIR (3 a bin each
        way), since its recursion runs through the pad and back;
      * the frames that overlap the clip: a forward and an inverse real
        FFT, |Y| (3 a bin), the sigmoid mask (about 6 a bin: subtract,
        divide, scale, exp, add, divide), the separable smoothing (2 a
        tap a bin), the blend (2 a bin), Y times the mask (2 a bin) and
        the window and overlap-add of the output (2 a sample of the frame);
      * the time taps' halo, half the taps each side: the mask and its
        smoothing over frequency (their spectra are zero, so no FFT);
    then the peak normalisation (2 a sample).  Frames are centred at
    multiples of the hop of the padded signal.  Bytes: the clip in, the
    clip out."""
    n_fft, hop, pad = cfg["n_fft"], cfg["hop_length"], cfg["pad"]
    k = n_fft // 2 + 1
    frames = 1 + (n + 2 * pad) // hop
    # frame t spans [t * hop - n_fft / 2, t * hop + n_fft / 2) and the clip [pad, pad + n)
    first = (pad - n_fft // 2) // hop + 1
    last = -(-(pad + n + n_fft // 2) // hop) - 1
    inside = last - first + 1
    kf, kt = cfg["freq_taps"], cfg["time_taps"]
    halo = min(2 * (kt // 2), frames - inside)
    iir = frames * 6 * k
    clip = inside * (2 * fft_ops(n_fft) + (3 + 6 + 2 * (kf + kt) + 2 + 2) * k + 2 * n_fft)
    edge = halo * (6 + 2 * kf) * k
    return iir + clip + edge + 2 * n, 2 * F32 * n


def features_149(n: int, fe: dict, mel_nonzeros: int, chroma_nonzeros: int,
                 band_bins: int) -> tuple[float, float]:
    """The 149-dim features of one clip of n samples: per frame the real
    FFT, the power (3 a bin), the mel product over the filterbank's
    nonzeros (2 each), dB (3 a mel: clamp, log, scale), the DCT (2 x mels x
    MFCC), the two SavGol deltas (2 x 9 taps x MFCC each), the piptrack
    candidates (about 20 a bin of its 150-4000 Hz band), the
    chroma product over its nonzeros (2 each) and its per-frame norm (2 a
    chroma bin); the masked means and stds (4 a value a frame over 3 x
    MFCC + chroma).  Bytes: the clip in, 149 features out."""
    n_fft, hop = fe["n_fft"], fe["hop_length"]
    n_mels, n_mfcc, n_chroma = fe["n_mels"], fe["n_mfcc"], fe["n_chroma"]
    k = n_fft // 2 + 1
    frames = 1 + n // hop
    per_frame = (fft_ops(n_fft) + 3 * k + 2 * mel_nonzeros + 3 * n_mels
                 + 2 * n_mels * n_mfcc + 2 * (2 * 9 * n_mfcc) + 20 * band_bins
                 + 2 * chroma_nonzeros + 2 * n_chroma + 4 * (3 * n_mfcc + n_chroma))
    return frames * per_frame, F32 * (n + 149)


def seq_frames(n: int, mel_nonzeros: int, t_max: int = 316) -> tuple[float, float]:
    """The sequence heads' frames of one clip: the 2048-point STFT at hop
    512, power, mel over the filterbank's nonzeros, dB, the 20 MFCC and
    their two deltas, for min(1 + n // 512, t_max) valid frames.  Bytes:
    the clip in, [t_max, 128 + 60] frames out."""
    k = 1025
    frames = min(1 + n // 512, t_max)
    per_frame = fft_ops(2048) + 3 * k + 2 * mel_nonzeros + 3 * 128 + 2 * 128 * 20 + 2 * 2 * 9 * 20
    return frames * per_frame, F32 * (n + t_max * (128 + 60))


def _conv_out(n: int) -> int:
    return -(-n // 2)  # stride 2, 'SAME'


def head(arch: str, n_valid: int, t_max: int = 316, n_classes: int = 3) -> float:
    """Multiply-adds x 2 of one head's forward on one clip, from its
    published widths: every product at t_max frames, as the heads run
    (zero-padded, masked), except the LSTM's steps, which run over the
    valid frames only; elementwise work is left out (it is a few percent
    of the products)."""
    if arch == "cnn":  # 3x3 convs 1-32-64-96 over (time 316, mel 128), stride 2
        t, f, c_in, ops = t_max, 128, 1, 0.0
        for c_out in (32, 64, 96):
            t, f = _conv_out(t), _conv_out(f)
            ops += 2 * 9 * c_in * c_out * t * f
            c_in = c_out
        return ops + 2 * c_in * n_classes
    if arch == "cnn_bilstm":  # width-5 convs 60-64-96, BiLSTM 96, dense 192 -> C
        t, c_in, ops = t_max, 60, 0.0
        for c_out in (64, 96):
            t = _conv_out(t)
            ops += 2 * 5 * c_in * c_out * t
            c_in = c_out
        steps = _conv_out(_conv_out(n_valid))
        ops += 2 * steps * 2 * (96 + 96) * 4 * 96  # two directions, x @ Wx + h @ Wh
        return ops + 2 * 192 * n_classes
    if arch == "transformer":  # stem 128-96-96 (width 5), 2 pre-LN blocks, d 96, ff 192
        t1 = _conv_out(t_max)
        t = _conv_out(t1)
        d, ff = 96, 192
        ops = 2 * 5 * 128 * d * t1 + 2 * 5 * d * d * t
        ops += 2 * (4 * 2 * t * d * d + 2 * 2 * t * t * d + 2 * 2 * t * d * ff)
        return ops + 2 * d * n_classes
    raise KeyError(arch)


# ------------------------------------------------ a configuration's stages

def _gate_cfg(config: dict) -> dict:
    from reference.config import denoise_config
    from reference.consts import mask_smoothing_profiles
    from reference.dsp import PAD

    dn = config["denoise"]
    prof = mask_smoothing_profiles(denoise_config(dn))
    f, t = (len(prof[0]), len(prof[1])) if prof is not None else (0, 0)
    return {"n_fft": dn["n_fft"], "hop_length": dn["hop_length"], "pad": PAD,
            "freq_taps": f, "time_taps": t}


def _mel_nonzeros(sr: int, n_fft: int, n_mels: int) -> int:
    from reference import filterbanks as fb

    return int((fb.mel_fb(sr, n_fft, n_mels) != 0).sum())


def _chroma_nonzeros(sr: int, n_fft: int, n_chroma: int) -> int:
    """Nonzeros of the chroma filterbank at tuning 0 (bin 50 of the 100)."""
    from reference import filterbanks as fb

    return int((fb.chroma_fb_table(sr, n_fft, n_chroma)[50] != 0).sum())


def _band_bins(sr: int, n_fft: int) -> int:
    """Bins of piptrack's band, as the reference's chroma takes them."""
    from reference.consts import PIP_FMAX, PIP_FMIN, band_range

    lo, hi = band_range(sr, n_fft, PIP_FMIN, PIP_FMAX)
    return hi - lo


def gate_work(lengths, config: dict) -> tuple[float, float]:
    """(operations, bytes) of the gate over clips of these lengths."""
    g = _gate_cfg(config)
    parts = [gate(int(n), g) for n in lengths if n > 0]  # padding rows need no work
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def features_work(lengths, config: dict) -> tuple[float, float]:
    """(operations, bytes) of the 149-dim features over clips of these lengths."""
    fe = config["frontend"]
    mel = _mel_nonzeros(fe["sample_rate"], fe["n_fft"], fe["n_mels"])
    chroma = _chroma_nonzeros(fe["sample_rate"], fe["n_fft"], fe["n_chroma"])
    band = _band_bins(fe["sample_rate"], fe["n_fft"])
    parts = [features_149(int(n), fe, mel, chroma, band) for n in lengths if n > 0]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def vote_ops(lengths, config: dict) -> float:
    """Operations of the weighted vote over clips of these lengths (at the
    front end's rate): the gate, the frames, every member's head."""
    mel = _mel_nonzeros(config["sample_rate"], 2048, 128)
    g = _gate_cfg(config)
    t_max = config["t_max"]
    ops = 0.0
    for n in lengths:
        n = int(n)
        nv = min(1 + n // 512, t_max)
        ops += gate(n, g)[0] + seq_frames(n, mel, t_max)[0]
        ops += sum(head(m["arch"], nv, t_max, len(config["classes"]))
                   for m in config["members"].values())
    return ops


def mlp_params(dims) -> int:
    """Weights and biases of one MLP of these layer widths."""
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def train_step_ops(dims, rows: int) -> float:
    """Operations of one training step over `rows` rows of MLPs of these
    widths: 6 a parameter a row (the forward's multiply-adds, and the
    backward's for the inputs and the weights); dropout, the loss and Adam
    are left out (under 1 % of it)."""
    return 6.0 * mlp_params(dims) * rows
