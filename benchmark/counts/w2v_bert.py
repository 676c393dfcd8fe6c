"""Operations and bytes of the W2V-BERT 2.0 clip encoder, counted from its
published shapes at each clip's own length (never the padded batch the
port sends, never its launches).

Conventions, beside counts/work.py's and counts/wavlm.py's (one FP32
operation = one add or one multiply; bytes: a stage's activations read
once and written once, float32; weights left out -- a batch reads each
once, about 2.3 GB a pass at the cell's 15 batches against ~30 GB of
activations):
  * a product of [T, a] by [a, b]: 2 T a b;
  * LayerNorm 7 a value, swish (x sigmoid(x)) 4, the GLU's gate 4, the
    log-mel's floor and log 2, softmax 5 a score;
  * a clip of n samples has F = 1 + (n - 400) // 160 fbank frames (none
    below 400 samples) and T = F // 2 frames in the encoder.
`encoder_stages` gives (operations, bytes) per stage of one clip; the
encoder's least time is the sum over stages of each stage's
counts/work.bound_s, summed over the clips first.  The conv module's
stages are its ops one by one (`CONV_STAGES`), so its least time takes,
for each op, the larger of its bytes over the HBM rate and its operations
over the FP32 peak.
"""

from __future__ import annotations

from .wavlm import LN, SOFTMAX, busy_s, mlp_ops  # noqa: F401  (busy_s, mlp_ops: the readers')
from .work import F32, bound_s, fft_ops

WIN, HOP, N_FFT, N_MELS = 400, 160, 512, 80
SWISH, GLU, LOG = 4, 4, 2
CONV_STAGES = ("conv_norm", "conv_pointwise1", "conv_glu", "conv_depthwise", "conv_norm_swish",
               "conv_pointwise2")


def fbank_frames(n: int) -> int:
    return 1 + (n - WIN) // HOP if n >= WIN else 0


def n_frames(n: int, enc: dict | None = None) -> int:
    """Encoder frames of a clip of n samples (the widths do not change
    them)."""
    return fbank_frames(n) // 2


def attention(T: int, enc: dict) -> tuple[float, float]:
    """One layer's relative-key attention core over T frames: each row's
    table of q . D over the left + right + 1 distances a head (2 d (left +
    right + 1) a row over the heads), the bias gathered and added and the
    mask added (2 a score), the 1/sqrt(d) scale (1), the softmax, q k^T and
    the product with v (2 T^2 d each).  Bytes: q, k, v in, the output out
    (4 T d); the distance table left out."""
    d, h = enc["hidden_size"], enc["num_attention_heads"]
    nrel = enc["left_max_position_embeddings"] + enc["right_max_position_embeddings"] + 1
    ops = T * 2 * d * nrel + h * T * T * (2 + 1 + SOFTMAX) + 2 * 2 * T * T * d
    return float(ops), float(F32 * 4 * T * d)


def conv_module(T: int, enc: dict) -> dict[str, tuple[float, float]]:
    """One layer's convolution module over T frames, op by op: the
    LayerNorm and the padding's zeroing (7 + 1 a value), the pointwise conv
    to 2 d, the GLU, the causal depthwise conv (2 a tap), the LayerNorm and
    swish, the pointwise conv back to d."""
    d, K = enc["hidden_size"], enc["conv_depthwise_kernel_size"]
    td = T * d
    return {"conv_norm": (float((LN + 1) * td), float(F32 * 2 * td)),
            "conv_pointwise1": (float(2 * td * 2 * d), float(F32 * 3 * td)),
            "conv_glu": (float(GLU * td), float(F32 * 3 * td)),
            "conv_depthwise": (float(2 * K * td), float(F32 * 2 * td)),
            "conv_norm_swish": (float((LN + SWISH) * td), float(F32 * 2 * td)),
            "conv_pointwise2": (float(2 * td * d), float(F32 * 2 * td))}


def encoder_stages(n: int, enc: dict) -> dict[str, tuple[float, float]]:
    """(operations, bytes) of each stage of the encoder on one clip of n
    samples: the fbank (the scale, each frame's mean removal, pre-emphasis
    and window (6 a sample of a frame), a real FFT of 512, the power (3 a
    bin), the mel filters (2 x 257 x 80 a frame), floor and log, the
    normalisation over the clip's frames (6 a value)); the projection with
    its LayerNorm; the layers' two half-step FFNs ("ffn": LayerNorm,
    products, swish, the half and the residual); their attention
    LayerNorm, q/k/v/out products and residual ("layers"); their attention
    cores ("attention"); their conv modules' ops (CONV_STAGES) and residual
    (in "layers"); their final LayerNorms and the mean ("final")."""
    F, T = fbank_frames(n), n_frames(n)
    d, f, L = enc["hidden_size"], enc["intermediate_size"], enc["num_hidden_layers"]
    c = enc["feature_projection_input_dim"]
    bins = N_FFT // 2 + 1
    out = {"fbank": (float(n + F * (6 * WIN + fft_ops(N_FFT) + 3 * bins + 2 * bins * N_MELS
                                    + (LOG + 6) * N_MELS)),
                     float(F32 * (n + T * c)))}
    out["projection"] = (float(LN * T * c + 2 * T * c * d), float(F32 * T * (c + d)))
    ffn = LN * T * d + 2 * 2 * T * d * f + SWISH * T * f + 2 * T * d
    out["ffn"] = (float(2 * L * ffn), float(2 * L * F32 * (3 * T * d + 2 * T * f)))
    # the attention's LayerNorm, 4 products and residual, and the conv
    # module's residual; bytes h in, x out, q/k/v out, the core's output
    # in, h out; the conv residual's two reads and a write
    layer = LN * T * d + 2 * T * d * d * 4 + 2 * T * d
    out["layers"] = (float(L * layer), float(L * F32 * (7 * T * d + 3 * T * d)))
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
