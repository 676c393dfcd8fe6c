"""WavLM as a clip embedding encoder: raw 16 kHz audio -> one pooled vector
a clip (WavLM-Large: 1024 dims), the front end of the embedding features
(config.EmbeddingFeatureConfig, ops/frontend.batch_extractor_for).

The equations are those of transformers' modeling_wavlm.py for the
stable-layer-norm model (WavLMModel with feat_extract_norm "layer",
conv_bias false, do_stable_layer_norm true), in inference:

  * the input: each clip's valid samples to zero mean and unit variance
    (eps 1e-7, Wav2Vec2FeatureExtractor's), the padding zero;
  * the feature encoder: 7 convolutions without bias, each followed by a
    LayerNorm over the channels at every frame and an exact GELU, run here
    channels-last as frame-window products (unfold, then one matmul);
  * the projection: LayerNorm, then Linear(conv_dim[-1] -> hidden_size);
  * frames past a clip's own (the conv length formula) are zeroed, then
    the positional conv embedding is added: a grouped Conv1d of
    num_conv_pos_embeddings taps, padding taps // 2, its weight
    weight-normed along dim 2 (g * v / |v|), the last output frame dropped,
    GELU;
  * num_hidden_layers pre-LN layers: LayerNorm, gated relative-position
    attention, residual; LayerNorm, FFN with GELU, residual; then a final
    LayerNorm.  Layer 0's rel_attn_embed [num_buckets, heads] gives one
    position bias [heads, T, T] that every layer reuses; each layer scales
    it per query row by a gate from its own input (gated_attention), and
    padded keys are masked out;
  * the embedding: the mean of the last hidden state over a clip's valid
    frames.

A clip's embedding is the same alone and inside a padded batch: valid
frames read only valid samples, the padded frames are zero before the
positional conv (whose own padding is zeros) and masked as keys, and the
position bias depends only on key minus query.

Weights live in a dict under the checkpoint's parameter names
(param_shapes; `masked_spec_embed`, used only in pre-training, is not
kept), so a checkpoint saved by persist.save_wavlm loads by name.
Without one they are drawn from the config's seed on the first device
that runs the encoder, at the published initial scales (init_params); each
other device gets a copy (parallel.mesh.replicate).

Traced (utils.profiling), an `encode` call is the span `wavlm.encode`,
holding `wavlm.featenc`, `wavlm.pos_conv` and one `wavlm.attention` per
layer, and counts `wavlm.batches`, `valid_frames`, `sent_frames`,
`attn_pairs_valid` (sum of T_i^2) and `attn_pairs_sent` (B x T_pad^2).
"""

from __future__ import annotations

import functools
import math
import threading

import torch
import torch.nn.functional as F

from stutter_tpu_torch.config import WavLMConfig
from stutter_tpu_torch.utils.profiling import count, span, tracing

CONV_LN_EPS = 1e-5  # the feature encoder's LayerNorms (nn.LayerNorm's default)
INPUT_EPS = 1e-7  # the input normalisation's (Wav2Vec2FeatureExtractor)
GATE_DIM = 8  # gru_rel_pos_linear's outputs: 2 groups of 4
# The longest clip the corpus path sends (ops/frontend's largest bucket,
# 10.24 s): the position-bias table is built once at its frames
LONGEST = 163840
# Samples an encode call takes at most: a batch of more rows x samples is
# encoded in row chunks (64 clips of the 10.24 s bucket are one call)
SAMPLE_BUDGET = 64 * LONGEST

LAYER = "encoder.layers.{}."


def frame_lengths(lengths, cfg: WavLMConfig):
    """Frames of the feature encoder for clips of `lengths` samples (ints or
    an integer tensor): the conv length formula, layer by layer, never
    below 0."""
    n = lengths
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n.clamp(min=0) if isinstance(n, torch.Tensor) else max(n, 0)


def param_shapes(cfg: WavLMConfig) -> dict[str, tuple]:
    """Every parameter's checkpoint name and shape, in the order they are
    drawn."""
    shapes: dict[str, tuple] = {}
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        pre = f"feature_extractor.conv_layers.{i}."
        shapes[pre + "conv.weight"] = (c, c_in, k)
        shapes[pre + "layer_norm.weight"] = (c,)
        shapes[pre + "layer_norm.bias"] = (c,)
        c_in = c
    d, h, f = cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size
    shapes["feature_projection.layer_norm.weight"] = (c_in,)
    shapes["feature_projection.layer_norm.bias"] = (c_in,)
    shapes["feature_projection.projection.weight"] = (d, c_in)
    shapes["feature_projection.projection.bias"] = (d,)
    k = cfg.num_conv_pos_embeddings
    shapes["encoder.pos_conv_embed.conv.weight_g"] = (1, 1, k)
    shapes["encoder.pos_conv_embed.conv.weight_v"] = (d, d // cfg.num_conv_pos_embedding_groups, k)
    shapes["encoder.pos_conv_embed.conv.bias"] = (d,)
    shapes["encoder.layer_norm.weight"] = (d,)
    shapes["encoder.layer_norm.bias"] = (d,)
    for i in range(cfg.num_hidden_layers):
        pre = LAYER.format(i)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{pre}attention.{proj}.weight"] = (d, d)
            shapes[f"{pre}attention.{proj}.bias"] = (d,)
        shapes[pre + "attention.gru_rel_pos_const"] = (1, h, 1, 1)
        shapes[pre + "attention.gru_rel_pos_linear.weight"] = (GATE_DIM, d // h)
        shapes[pre + "attention.gru_rel_pos_linear.bias"] = (GATE_DIM,)
        if i == 0:
            shapes[pre + "attention.rel_attn_embed.weight"] = (cfg.num_buckets, h)
        for ln in ("layer_norm", "final_layer_norm"):
            shapes[f"{pre}{ln}.weight"] = (d,)
            shapes[f"{pre}{ln}.bias"] = (d,)
        shapes[pre + "feed_forward.intermediate_dense.weight"] = (f, d)
        shapes[pre + "feed_forward.intermediate_dense.bias"] = (f,)
        shapes[pre + "feed_forward.output_dense.weight"] = (d, f)
        shapes[pre + "feed_forward.output_dense.bias"] = (d,)
    return shapes


def n_params(cfg: WavLMConfig) -> int:
    """Parameters of the encoder, reckoned from the shapes alone."""
    return sum(math.prod(s) for s in param_shapes(cfg).values())


def init_params(cfg: WavLMConfig, device, seed: int | None = None) -> dict[str, torch.Tensor]:
    """The weights drawn on `device` from a generator seeded with `seed`
    (the config's by default), name by name in param_shapes' order, at the
    published initial scales: the feature encoder's convs Kaiming-normal
    (std sqrt(2 / fan_in)), the projection uniform in +-sqrt(1 / fan_in),
    the positional conv's v normal with std 2 sqrt(1 / (taps x hidden))
    and g = |v| (so the weight starts as v), every other Linear normal with
    std 0.02 and zero bias, rel_attn_embed standard normal (nn.Embedding),
    gru_rel_pos_const ones, LayerNorms ones and zeros."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg.seed if seed is None else seed))
    out = {}

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound

    v_name = "encoder.pos_conv_embed.conv.weight_v"
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("feature_extractor") and name.endswith("conv.weight"):
            out[name] = normal(shape, math.sqrt(2.0 / (shape[1] * shape[2])))
        elif name.startswith("feature_projection.projection"):
            out[name] = uniform(shape, math.sqrt(1.0 / cfg.conv_dim[-1]))
        elif name == "encoder.pos_conv_embed.conv.weight_g":
            continue  # drawn with v, after it
        elif name == v_name:
            v = normal(shape, 2.0 * math.sqrt(1.0 / (shape[2] * cfg.hidden_size)))
            out[name] = v
            out["encoder.pos_conv_embed.conv.weight_g"] = v.norm(dim=(0, 1), keepdim=True)
        elif "layer_norm" in name:
            out[name] = torch.full(shape, 1.0 if leaf == "weight" else 0.0, device=device)
        elif name.endswith("rel_attn_embed.weight"):
            out[name] = normal(shape, 1.0)
        elif name.endswith("gru_rel_pos_const"):
            out[name] = torch.ones(shape, device=device)
        elif leaf == "weight":
            out[name] = normal(shape, 0.02)
        else:
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name in param_shapes(cfg)}


# ------------------------------------------------------------------ stages

def _valid(t_len: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T] True at each clip's own frames (or samples)."""
    return torch.arange(T, device=t_len.device)[None, :] < t_len[:, None]


def normalise(audio: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each clip's valid samples to zero mean and unit (population)
    variance, eps INPUT_EPS; the padding zero."""
    m = _valid(lengths, audio.shape[1])
    n = lengths.clamp(min=1).to(audio.dtype)[:, None]
    mean = torch.where(m, audio, 0.0).sum(1, keepdim=True) / n
    var = torch.where(m, (audio - mean) ** 2, 0.0).sum(1, keepdim=True) / n
    return torch.where(m, (audio - mean) / torch.sqrt(var + INPUT_EPS), 0.0)


def feature_encoder(p: dict, audio: torch.Tensor, lengths: torch.Tensor,
                    cfg: WavLMConfig) -> torch.Tensor:
    """audio [B, N] (zero-padded), lengths [B] -> the conv features [B, T,
    conv_dim[-1]] of the padded length (frames past a clip's own are
    whatever its padding gives).  Each conv is a product of the frames'
    sample windows ([B, T, c_in x k], unfold) with the weight [c_in x k,
    c_out], channels last, so the LayerNorm runs on rows."""
    h = normalise(audio, lengths)[:, :, None]
    for i, (c, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
        pre = f"feature_extractor.conv_layers.{i}."
        w = p[pre + "conv.weight"]
        cols = h.unfold(1, k, s)  # [B, T', c_in, k]
        h = cols.reshape(*cols.shape[:2], -1) @ w.reshape(c, -1).T
        h = F.gelu(F.layer_norm(h, (c,), p[pre + "layer_norm.weight"],
                                p[pre + "layer_norm.bias"], CONV_LN_EPS))
    return h


def project(p: dict, h: torch.Tensor, cfg: WavLMConfig) -> torch.Tensor:
    """LayerNorm over the conv channels, then Linear to hidden_size."""
    h = F.layer_norm(h, (h.shape[-1],), p["feature_projection.layer_norm.weight"],
                     p["feature_projection.layer_norm.bias"], cfg.layer_norm_eps)
    return F.linear(h, p["feature_projection.projection.weight"],
                    p["feature_projection.projection.bias"])


def positional_conv(p: dict, h: torch.Tensor, cfg: WavLMConfig) -> torch.Tensor:
    """The positional embedding of h [B, T, D] (its padded frames zero):
    the weight-normed grouped conv, the last frame dropped, GELU -> [B, T,
    D]."""
    g, v = p["encoder.pos_conv_embed.conv.weight_g"], p["encoder.pos_conv_embed.conv.weight_v"]
    w = v * (g / v.norm(dim=(0, 1), keepdim=True))
    k = cfg.num_conv_pos_embeddings
    c = F.conv1d(h.transpose(1, 2), w, p["encoder.pos_conv_embed.conv.bias"], padding=k // 2,
                 groups=cfg.num_conv_pos_embedding_groups)
    if k % 2 == 0:
        c = c[:, :, :-1]
    return F.gelu(c).transpose(1, 2)


def relative_buckets(T: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """[T, T] bucket of key minus query, on the host, in float32 as
    _relative_positions_bucket computes it: half the buckets a sign, the
    first half of those exact, the rest log-spaced up to max_distance."""
    rel = torch.arange(T)[None, :] - torch.arange(T)[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    exact = half // 2
    large = torch.log(rel.clamp(min=1).float() / exact) / math.log(max_distance / exact)
    large = torch.clamp((exact + large * (half - exact)).to(torch.long), max=half - 1)
    return buckets + torch.where(rel < exact, rel, large)


@functools.lru_cache(maxsize=64)
def _bucket_table(T: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    return relative_buckets(T, num_buckets, max_distance).to(device)


def position_bias(p: dict, T: int, cfg: WavLMConfig, device) -> torch.Tensor:
    """Layer 0's relative position bias [heads, T, T], from the [:T, :T]
    corner of one bucket table a device, built at the frames of LONGEST
    (or at T, past them): a bucket depends only on key minus query, so the
    corner is relative_buckets(T), and a batch of a new length costs no
    table of its own."""
    rows = max(T, frame_lengths(LONGEST, cfg))
    table = _bucket_table(rows, cfg.num_buckets, cfg.max_bucket_distance, torch.device(device))
    return p[LAYER.format(0) + "attention.rel_attn_embed.weight"][table[:T, :T]].permute(2, 0, 1)


def bias_gate(p: dict, i: int, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Layer i's gate of the position bias per query row, from its input x
    [B, T, D]: each head's slice through gru_rel_pos_linear (-> 8), summed
    in 2 groups of 4, sigmoid -> a, b; a (b const_h - 1) + 2 -> [B, heads,
    T]."""
    pre = LAYER.format(i) + "attention."
    B, T, D = x.shape
    proj = F.linear(x.view(B, T, heads, D // heads), p[pre + "gru_rel_pos_linear.weight"],
                    p[pre + "gru_rel_pos_linear.bias"])
    a, b = torch.sigmoid(proj.view(B, T, heads, 2, GATE_DIM // 2).sum(-1)).unbind(-1)
    const = p[pre + "gru_rel_pos_const"].view(1, 1, heads)
    return (a * (b * const - 1.0) + 2.0).transpose(1, 2)


def key_mask(valid: torch.Tensor) -> torch.Tensor:
    """[B, T] valid frames -> [B, 1, 1, T] additive mask: 0 on a clip's
    frames, -inf on its padding."""
    return torch.where(valid, 0.0, float("-inf"))[:, None, None, :]


def gated_attention(p: dict, i: int, x: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor,
                    cfg: WavLMConfig) -> torch.Tensor:
    """Layer i's attention core: q, k, v [B, heads, T, head_dim], the
    position bias [heads, T, T] gated per query row by bias_gate(x) plus the
    key mask [B, 1, 1, T], softmax(q k^T / sqrt(head_dim) + that) v ->
    [B, heads, T, head_dim]."""
    gate = bias_gate(p, i, x, cfg.num_attention_heads)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=gate[..., None] * bias + mask)


def encoder_layer(p: dict, i: int, h: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor,
                  cfg: WavLMConfig) -> torch.Tensor:
    """One stable-layer-norm layer: h + attention(LN(h)), then + FFN(LN(.))."""
    pre = LAYER.format(i)
    B, T, D = h.shape
    heads = cfg.num_attention_heads
    x = F.layer_norm(h, (D,), p[pre + "layer_norm.weight"], p[pre + "layer_norm.bias"],
                     cfg.layer_norm_eps)

    def proj(name):
        y = F.linear(x, p[f"{pre}attention.{name}.weight"], p[f"{pre}attention.{name}.bias"])
        return y.view(B, T, heads, D // heads).transpose(1, 2)

    q, k, v = proj("q_proj"), proj("k_proj"), proj("v_proj")
    with span("wavlm.attention"):
        a = gated_attention(p, i, x, q, k, v, bias, mask, cfg)
    h = h + F.linear(a.transpose(1, 2).reshape(B, T, D), p[pre + "attention.out_proj.weight"],
                     p[pre + "attention.out_proj.bias"])
    y = F.layer_norm(h, (D,), p[pre + "final_layer_norm.weight"],
                     p[pre + "final_layer_norm.bias"], cfg.layer_norm_eps)
    y = F.gelu(F.linear(y, p[pre + "feed_forward.intermediate_dense.weight"],
                        p[pre + "feed_forward.intermediate_dense.bias"]))
    return h + F.linear(y, p[pre + "feed_forward.output_dense.weight"],
                        p[pre + "feed_forward.output_dense.bias"])


def _count(t_len: torch.Tensor, B: int, T: int) -> None:
    t = t_len.cpu().to(torch.int64)
    count("wavlm.batches", 1)
    count("wavlm.valid_frames", int(t.sum()))
    count("wavlm.sent_frames", B * T)
    count("wavlm.attn_pairs_valid", int((t * t).sum()))
    count("wavlm.attn_pairs_sent", B * T * T)


def encode(p: dict, audio: torch.Tensor, lengths: torch.Tensor,
           cfg: WavLMConfig) -> torch.Tensor:
    """audio [B, N] (zero-padded), lengths [B] samples -> the embeddings
    [B, hidden_size]: the mean of the last hidden state over each clip's
    frames (zero for a clip too short to give one)."""
    B, N = audio.shape
    lengths = lengths.to(audio.device).long()
    T = frame_lengths(N, cfg)
    if T <= 0:
        return audio.new_zeros(B, cfg.hidden_size)
    with span("wavlm.encode"):
        t_len = frame_lengths(lengths, cfg)
        if tracing():
            _count(t_len, B, T)
        with span("wavlm.featenc"):
            h = feature_encoder(p, audio, lengths, cfg)
        valid = _valid(t_len, T)
        h = torch.where(valid[..., None], project(p, h, cfg), 0.0)
        with span("wavlm.pos_conv"):
            h = h + positional_conv(p, h, cfg)
        bias = position_bias(p, T, cfg, audio.device)
        # a clip of no frame attends to its first (padded) one, so no row
        # of the softmax is empty; its embedding is zeroed below
        mask = key_mask(valid | (torch.arange(T, device=audio.device) == 0)[None, :])
        for i in range(cfg.num_hidden_layers):
            h = encoder_layer(p, i, h, bias, mask, cfg)
        h = F.layer_norm(h, (cfg.hidden_size,), p["encoder.layer_norm.weight"],
                         p["encoder.layer_norm.bias"], cfg.layer_norm_eps)
        summed = torch.where(valid[..., None], h, 0.0).sum(1)
        return summed / t_len.clamp(min=1).to(h.dtype)[:, None]


# ------------------------------------------------------- weights per device

class Encoder:
    """One configuration's weights, one copy per device that ran it: the
    first device's loaded (cfg.weights) or drawn (init_params), every
    other's copied from it (parallel.mesh.replicate)."""

    def __init__(self, cfg: WavLMConfig):
        self.cfg = cfg
        self.lock = threading.Lock()
        self.replicas: dict[torch.device, dict] = {}

    def params(self, device) -> dict[str, torch.Tensor]:
        device = torch.device(device)
        with self.lock:
            if device not in self.replicas:
                if self.replicas:
                    from stutter_tpu_torch.parallel.mesh import replicate

                    self.replicas[device] = replicate([device], next(iter(
                        self.replicas.values())))[0]
                elif self.cfg.weights is not None:
                    from stutter_tpu_torch.persist import load_wavlm

                    self.replicas[device] = load_wavlm(self.cfg.weights, self.cfg, device)
                else:
                    self.replicas[device] = init_params(self.cfg, device)
            return self.replicas[device]


_ENCODERS: dict[WavLMConfig, Encoder] = {}
_ENCODERS_LOCK = threading.Lock()


def encoder_for(cfg: WavLMConfig) -> Encoder:
    """The process's Encoder of `cfg` (made at the first call)."""
    with _ENCODERS_LOCK:
        return _ENCODERS.setdefault(cfg, Encoder(cfg))


def release() -> None:
    """Drop every Encoder's weights (the next call loads or draws them
    again)."""
    with _ENCODERS_LOCK:
        _ENCODERS.clear()
    _bucket_table.cache_clear()


def batch_fn_for(cfg: WavLMConfig, text_len: int = 5):
    """`batch_fn(audio [B, N], lengths [B]) -> [B, hidden_size + text_len]`
    on audio's device: the embeddings (encode, with that device's weights;
    in row chunks of at most SAMPLE_BUDGET samples), then text_len zero
    placeholders.  It carries the feature encoder's stride in samples
    (`frame_stride`), by which ops/frontend.run_bucketed pads its batches
    only to their longest clip: a clip's embedding does not depend on N."""
    enc = encoder_for(cfg)

    def batch_fn(audio, lengths):
        p = enc.params(audio.device)
        B, N = audio.shape
        rows = max(1, SAMPLE_BUDGET // max(N, 1))
        parts = [encode(p, audio[s : s + rows], lengths[s : s + rows], cfg)
                 for s in range(0, B, rows)]
        emb = parts[0] if len(parts) == 1 else torch.cat(parts)
        return torch.cat([emb, emb.new_zeros(B, text_len)], dim=1)

    batch_fn.frame_stride = math.prod(cfg.conv_stride)
    return batch_fn
