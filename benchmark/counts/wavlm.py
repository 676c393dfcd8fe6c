"""Operations and bytes of the WavLM clip encoder, counted from its
published shapes at each clip's own length (never the padded batch the
port sends, never its launches).

Conventions, beside counts/work.py's (one FP32 operation = one add or one
multiply; bytes: a stage's activations read once and written once,
float32; weights left out -- a batch reads each once, under 2 % of the
bytes of a pass at the cell's batch):
  * a product of [T, a] by [a, b]: 2 T a b;
  * LayerNorm 7 a value (mean, subtract, square, mean, scale, affine 2),
    GELU 8 a value, softmax 5 a score (max, subtract, exp, sum, divide);
  * a clip of n samples has T_j frames after conv j (the conv length
    formula) and T = T_6 frames in the transformer.
`encoder_stages` gives (operations, bytes) per stage of one clip; the
encoder's least time is the sum over stages of each stage's
counts/work.bound_s, summed over the clips first.
"""

from __future__ import annotations

from .work import F32, bound_s

LN, GELU, SOFTMAX = 7, 8, 5


def conv_frames(n: int, enc: dict) -> list[int]:
    """Frames after each conv of the feature encoder, for n samples."""
    out = []
    for k, s in zip(enc["conv_kernel"], enc["conv_stride"]):
        n = max((n - k) // s + 1, 0)
        out.append(n)
    return out


def n_frames(n: int, enc: dict) -> int:
    return conv_frames(n, enc)[-1]


def attention(T: int, enc: dict) -> tuple[float, float]:
    """One layer's gated-bias attention core over T frames: the gate (each
    head's 64 -> 8 product, the two sums of 4, two sigmoids of 4 each, a
    (b c - 1) + 2 in 4), the bias gathered and scaled per query row and
    the mask added (2 a score), q k^T (2 T^2 d), the 1/sqrt(d) scale (1 a
    score), the softmax, and the product with v (2 T^2 d).  Bytes: x, q, k,
    v in, the output out (5 T d), the gate's weights and the bias table
    left out."""
    d, h = enc["hidden_size"], enc["num_attention_heads"]
    dh = d // h
    gate = T * h * (2 * dh * 8 + 2 * 3 + 2 * 4 + 4)
    scores = h * T * T
    ops = gate + scores * (2 + 1 + SOFTMAX) + 2 * 2 * T * T * d
    return float(ops), float(F32 * 5 * T * d)


def encoder_stages(n: int, enc: dict) -> dict[str, tuple[float, float]]:
    """(operations, bytes) of each stage of the encoder on one clip of n
    samples: the input normalisation (5 a sample: two sums, subtract, square,
    scale), each conv with its LayerNorm and GELU, the projection with its
    LayerNorm, the positional conv (grouped, its GELU and the add), the
    layers' LayerNorms, q/k/v/out products and residuals ("layers"), their
    attention cores ("attention"), their FFNs, and the final LayerNorm and
    the mean."""
    frames = conv_frames(n, enc)
    T = frames[-1]
    d, f, L = enc["hidden_size"], enc["intermediate_size"], enc["num_hidden_layers"]
    out = {"normalise": (5.0 * n, 2.0 * F32 * n)}
    c_in, t_in = 1, n
    for j, (c, k, t) in enumerate(zip(enc["conv_dim"], enc["conv_kernel"], frames)):
        out[f"conv{j}"] = (float(2 * c_in * k * c * t + (LN + GELU) * c * t),
                           float(F32 * (c_in * t_in + c * t)))
        c_in, t_in = c, t
    out["projection"] = (float(LN * c_in * T + 2 * T * c_in * d), float(F32 * T * (c_in + d)))
    g, kp = enc["num_conv_pos_embedding_groups"], enc["num_conv_pos_embeddings"]
    out["pos_conv"] = (float(2 * T * (d // g) * kp * d + (GELU + 1) * T * d),
                       float(F32 * 2 * T * d))
    # per layer: 2 LayerNorms, q/k/v/out products, 2 residual adds; bytes
    # h in, x out, q/k/v out, the core's output in, h out twice (8 T d)
    layer = LN * 2 * T * d + 2 * T * d * d * 4 + 2 * T * d
    out["layers"] = (float(L * layer), float(L * F32 * 8 * T * d))
    a_ops, a_bytes = attention(T, enc)
    out["attention"] = (L * a_ops, L * a_bytes)
    out["ffn"] = (float(L * (2 * 2 * T * d * f + GELU * T * f)),
                  float(L * F32 * (2 * T * d + 2 * T * f)))
    out["final"] = (float(LN * T * d + T * d), float(F32 * (T * d + d)))
    return out


def encoder_work(lengths, enc: dict) -> dict[str, tuple[float, float]]:
    """encoder_stages summed over clips of these lengths (a clip of no frame
    needs no work)."""
    total: dict[str, list] = {}
    for n in lengths:
        n = int(n)
        if n_frames(n, enc) <= 0:
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


def pairs(lengths, enc: dict) -> tuple[int, int]:
    """(sum T_i, sum T_i^2) of these clips: the frames and attention pairs
    the work is counted at."""
    t = [n_frames(int(n), enc) for n in lengths]
    return sum(t), sum(x * x for x in t)


def mlp_ops(rows: int, dims, n_seeds: int) -> float:
    """The seeded MLP's products over `rows` rows (2 a weight a row a seed;
    biases, ReLUs and the softmax left out: under 1 %)."""
    return 2.0 * rows * n_seeds * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def busy_s(kernels) -> float:
    """Seconds in which one of `kernels` (tracing.Kernel) ran: the union of
    their [start, end] us on each device, summed over the devices (cuDNN
    runs the positional conv's groups side by side on several streams, so
    their durations overlap)."""
    total = 0.0
    for d in {k.device for k in kernels}:
        end = float("-inf")
        for s, e in sorted((k.start, k.end) for k in kernels if k.device == d):
            total += max(0.0, e - max(s, end))
            end = max(end, e)
    return total * 1e-6
