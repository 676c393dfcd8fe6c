"""Operations and bytes of the Parakeet-CTC-1.1B clip encoder, counted from
its published shapes at each clip's own length (never the padded batch the
port sends, never its launches or its choice of how often to project the
positional table).

Conventions, beside counts/work.py's, counts/wavlm.py's and
counts/w2v_bert.py's (one FP32 operation = one add or one multiply; bytes:
a stage's activations read once and written once, float32; weights left
out -- a batch reads each once, 4.25 GB an encode call):
  * a product of [T, a] by [a, b]: 2 T a b, and T b for its bias;
  * LayerNorm 7 a value, SiLU 4, the GLU's gate 4, BatchNorm 2, ReLU 1,
    a time mask 1, the log-mel's guard and log 2, softmax 5 a score;
  * a clip of n samples has F = n // 160 log-mel frames and T = F halved
    three times ((x + 1) // 2) encoder frames;
  * the positional term (q + v) . P[i - j] at each clip's T^2 pairs, and
    its projection relative_k_proj over the 2 T - 1 distances of each clip
    (transformers projects them a clip; the port once an encode call over
    its longest clip's, fewer rows, which the count does not follow).
`encoder_stages` gives (operations, bytes) per stage of one clip; the
encoder's least time is the sum over stages of each stage's
counts/work.bound_s, summed over the clips first.  The conv module's
stages are its ops one by one: its LayerNorm ("conv_norm"), then
`CONV_STAGES`.
"""

from __future__ import annotations

from .wavlm import LN, SOFTMAX, busy_s, mlp_ops  # noqa: F401  (busy_s, mlp_ops: the readers')
from .work import F32, bound_s, fft_ops

HOP, N_FFT, N_MELS = 160, 512, 80
SILU, GLU, LOG, BN, RELU, MASK = 4, 4, 2, 2, 1, 1
# the conv module's ops after its LayerNorm: what models.parakeet.conv_module
# computes (its LayerNorm is its argument, "conv_norm")
CONV_STAGES = ("conv_pointwise1", "conv_glu", "conv_depthwise", "conv_silu", "conv_pointwise2")


def mel_frames(n: int) -> int:
    return n // HOP


def n_frames(n: int, enc: dict | None = None) -> int:
    """Encoder frames of a clip of n samples (the widths do not change
    them)."""
    t = mel_frames(n)
    for _ in range(3):
        t = (t + 1) // 2
    return t


def stem(n: int, enc: dict) -> tuple[float, float]:
    """The stem over one clip: the 3 x 3 stride-2 conv 1 -> C, then twice a
    depthwise 3 x 3 stride-2 conv and a pointwise C -> C conv, each output
    masked in time and the first and the pointwise ones ReLU'd, then the
    Linear(C x 10 -> d) with its bias and the x sqrt(d) scale.  Bytes: the
    log-mel in, each conv's output written and read, the frames out."""
    C, d, k = enc["subsampling_conv_channels"], enc["hidden_size"], enc["subsampling_conv_kernel_size"]
    t, m = mel_frames(n), enc["num_mel_bins"]
    ops, n_bytes = 0.0, F32 * t * m
    for j in range(3):
        t, m = (t + 1) // 2, (m + 1) // 2
        if j == 0:
            ops += (2 * k * k + 1 + MASK + RELU) * C * t * m
        else:
            ops += (2 * k * k + 1 + MASK) * C * t * m + (2 * C + 1 + MASK + RELU) * C * t * m
        n_bytes += F32 * 2 * C * t * m * (1 if j == 0 else 2)
    ops += 2 * t * C * m * d + 2 * t * d
    n_bytes += F32 * t * d
    return float(ops), float(n_bytes)


def attention(T: int, enc: dict) -> tuple[float, float]:
    """One layer's relative attention core over T frames: q + u and q + v
    (2 d a row), 8 a score for the scale, the mask and the softmax over the
    heads, and three products a pair -- (q + u) k^T, (q + v) P[i - j]^T and
    the product with v -- 2 d each.  Bytes: q, k, v in, the output out, and
    the 2 T - 1 rows of the positional table in."""
    d, h = enc["hidden_size"], enc["num_attention_heads"]
    ops = T * 2 * d + h * T * T * (2 + 1 + SOFTMAX) + 3 * 2 * T * T * d
    return float(ops), float(F32 * (4 * T * d + (2 * T - 1) * d))


def position(T: int, enc: dict) -> tuple[float, float]:
    """One layer's positional projection for one clip: relative_k_proj (no
    bias) over the sinusoids of its 2 T - 1 distances."""
    d = enc["hidden_size"]
    rows = max(2 * T - 1, 0)
    return float(2 * rows * d * d), float(F32 * 2 * rows * d)


def conv_module(T: int, enc: dict) -> dict[str, tuple[float, float]]:
    """One layer's convolution module over T frames, op by op: its
    LayerNorm, the pointwise conv to 2 d with its bias, the GLU, the centred
    depthwise conv with its bias and BatchNorm (2 a tap, 1, 2), SiLU, the
    pointwise conv back to d with its bias."""
    d, K = enc["hidden_size"], enc["conv_kernel_size"]
    td = T * d
    return {"conv_norm": (float(LN * td), float(F32 * 2 * td)),
            "conv_pointwise1": (float(2 * td * 2 * d + 2 * td), float(F32 * 3 * td)),
            "conv_glu": (float(GLU * td), float(F32 * 3 * td)),
            "conv_depthwise": (float((2 * K + 1 + BN) * td), float(F32 * 2 * td)),
            "conv_silu": (float(SILU * td), float(F32 * 2 * td)),
            "conv_pointwise2": (float(2 * td * d + td), float(F32 * 2 * td))}


def encoder_stages(n: int, enc: dict) -> dict[str, tuple[float, float]]:
    """(operations, bytes) of each stage of the encoder on one clip of n
    samples: the log-mel (pre-emphasis and its mask (3 a sample), the
    window (512 a frame), a real FFT of 512, the power (3 a bin), the mel
    filters (2 x 257 x 80 a frame), the guard and log, the normalisation
    over the clip's frames (6 a value)); the stem; the blocks' two
    half-step FFNs ("ffn": LayerNorm, products and biases, SiLU, the half
    and the residual); their attention LayerNorm, q/k/v/o products and
    biases and the residuals of the attention and the conv module
    ("layers"); their positional projections ("position"); their attention
    cores ("attention"); their conv modules' ops (CONV_STAGES); their
    closing LayerNorms and the mean ("final")."""
    F, T = mel_frames(n), n_frames(n)
    d, f, L = enc["hidden_size"], enc["intermediate_size"], enc["num_hidden_layers"]
    bins = N_FFT // 2 + 1
    out = {"fbank": (float(3 * n + F * (N_FFT + fft_ops(N_FFT) + 3 * bins + 2 * bins * N_MELS
                                        + (LOG + 6) * N_MELS)),
                     float(F32 * (n + F * N_MELS)))}
    out["stem"] = stem(n, enc)
    ffn = LN * T * d + 2 * 2 * T * d * f + T * f + SILU * T * f + T * d + 2 * T * d
    out["ffn"] = (float(2 * L * ffn), float(2 * L * F32 * (3 * T * d + 2 * T * f)))
    layer = LN * T * d + 4 * (2 * T * d * d + T * d) + 2 * T * d
    out["layers"] = (float(L * layer), float(L * F32 * 10 * T * d))
    p_ops, p_bytes = position(T, enc)
    out["position"] = (L * p_ops, L * p_bytes)
    a_ops, a_bytes = attention(T, enc)
    out["attention"] = (L * a_ops, L * a_bytes)
    for k, (o, b) in conv_module(T, enc).items():
        out[k] = (L * o, L * b)
    out["final"] = (float(L * LN * T * d + T * d), float(F32 * (L * 2 * T * d + T * d + d)))
    return out


def encoder_work(lengths, enc: dict) -> dict[str, tuple[float, float]]:
    """encoder_stages summed over clips of these lengths (a clip of no frame
    needs no work)."""
    total: dict[str, list] = {}
    for n in lengths:
        n = int(n)
        if n_frames(n) <= 0:
            continue
        for k, (o, b) in encoder_stages(n, enc).items():
            t = total.setdefault(k, [0.0, 0.0])
            t[0] += o
            t[1] += b
    return {k: (v[0], v[1]) for k, v in total.items()}


def encoder_ops(lengths, enc: dict) -> float:
    return sum(o for o, _ in encoder_work(lengths, enc).values())


def encoder_bound_s(lengths, enc: dict) -> float:
    """The encoder's least time over these clips: each stage's bound, summed."""
    return sum(bound_s(o, b) for o, b in encoder_work(lengths, enc).values())


def attention_bound_s(lengths, enc: dict) -> float:
    """The attention cores' least time over these clips, every layer."""
    w = encoder_work(lengths, enc).get("attention")
    return bound_s(*w) if w else 0.0


def conv_module_bound_s(lengths, enc: dict) -> float:
    """The conv modules' least time over these clips, every layer: each op
    at the larger of its bytes' and its operations' time, summed."""
    w = encoder_work(lengths, enc)
    return sum(bound_s(*w[k]) for k in CONV_STAGES if k in w)


def pairs(lengths, enc: dict | None = None) -> tuple[int, int]:
    """(sum T_i, sum T_i^2) of these clips: the frames and attention pairs
    the work is counted at."""
    t = [n_frames(int(n)) for n in lengths]
    return sum(t), sum(x * x for x in t)
