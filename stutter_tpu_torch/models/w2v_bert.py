"""W2V-BERT 2.0 as a clip embedding encoder: raw 16 kHz audio -> one pooled
vector a clip (1024 dims at the published widths), the front end of the
embedding features (config.EmbeddingFeatureConfig with a W2VBertConfig,
ops/frontend.batch_extractor_for).

The equations are those of transformers' modeling_wav2vec2_bert.py
(Wav2Vec2BertModel with position_embeddings_type "relative_key", no
adapter, no intermediate FFN), in inference, over the input of
SeamlessM4TFeatureExtractor:

  * the input: ops/fbank.features, 80 log-mel bins a 10 ms frame, each
    clip normalised over its own frames, pairs stacked to 160 dims at
    50 Hz;
  * the feature projection: LayerNorm(160), then Linear(160 -> hidden);
  * rows past a clip's frames zeroed;
  * num_hidden_layers Conformer layers, each:
      h += 1/2 FFN1(LN(h));
      h += out_proj(attention(LN(h))), the relative-key attention
           softmax((q k^T + q D[clamp(j - i, -left, right) + left]^T) /
           sqrt(head_dim)) v, D the layer's distance_embedding shared by
           the heads, padded keys masked (relkey_attention: on a CUDA
           device the relative-key mode of csrc/gated_attention.cu, with
           no [T, T] tensor);
      h += conv_module(h): LN, the rows past a clip's frames zeroed, a
           pointwise conv to 2 x hidden without bias, GLU, a causal
           depthwise conv of conv_depthwise_kernel_size taps (left pad
           taps - 1, no bias), LN, swish, a pointwise conv without bias;
      h += 1/2 FFN2(LN(h)), then the layer's final LN;
    each FFN Linear(hidden -> intermediate), swish, Linear back;
  * the embedding: the mean of the last hidden state over a clip's frames
    (zero for a clip too short to give one).

A clip's embedding is the same alone and inside a padded batch: its fbank
rows read only its samples and its own frames' statistics, the padded rows
are zero after the projection, masked as keys in every attention, zeroed
before every conv module's depthwise conv (which is causal, so a clip's
frames never read a later one) and left out of the mean.

Weights live in a dict under the checkpoint's parameter names
(param_shapes; `masked_spec_embed`, used only in pre-training, is not
kept), so a checkpoint saved by persist.save_wavlm loads by name.
Without one they are drawn from the config's seed on the first device that
runs the encoder, at the published initial scales (init_params); each
other device gets a copy (parallel.mesh.replicate).

Traced (utils.profiling), an `encode` call is the span `w2v_bert.encode`,
holding `w2v_bert.fbank` and, a layer, one `w2v_bert.attention` and one
`w2v_bert.conv_module`, and counts `w2v_bert.batches`, `valid_frames`,
`sent_frames`, `attn_pairs_valid` (sum of T_i^2), `attn_pairs_sent`
(B x T_pad^2) and `attn_pairs_run` (the pairs the attention kernel
multiplies: wavlm.attn_pairs_run, the two modes tile alike).
"""

from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F

from stutter_tpu_torch import _build
from stutter_tpu_torch.config import W2VBertConfig
from stutter_tpu_torch.models import wavlm
from stutter_tpu_torch.ops import fbank
from stutter_tpu_torch.utils.profiling import count, span, tracing

ATTN_HEAD_DIM = wavlm.ATTN_HEAD_DIM  # the attention kernel's head width
NREL_MAX = 80  # distances the kernel's relative-key table holds
LAYER = "encoder.layers.{}."


# encoder frames of clips of n samples: (1 + (n - 400) // 160) // 2, and 0
# below 400 samples
frame_lengths = fbank.frame_lengths


def param_shapes(cfg: W2VBertConfig) -> dict[str, tuple]:
    """Every parameter's checkpoint name and shape, in the order they are
    drawn."""
    d, f, c = cfg.hidden_size, cfg.intermediate_size, cfg.feature_projection_input_dim
    shapes: dict[str, tuple] = {
        "feature_projection.layer_norm.weight": (c,),
        "feature_projection.layer_norm.bias": (c,),
        "feature_projection.projection.weight": (d, c),
        "feature_projection.projection.bias": (d,),
    }
    nrel = cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1
    for i in range(cfg.num_hidden_layers):
        pre = LAYER.format(i)

        def ln(name):
            shapes[f"{pre}{name}.weight"] = (d,)
            shapes[f"{pre}{name}.bias"] = (d,)

        def ffn(name):
            shapes[f"{pre}{name}.intermediate_dense.weight"] = (f, d)
            shapes[f"{pre}{name}.intermediate_dense.bias"] = (f,)
            shapes[f"{pre}{name}.output_dense.weight"] = (d, f)
            shapes[f"{pre}{name}.output_dense.bias"] = (d,)

        ln("ffn1_layer_norm")
        ffn("ffn1")
        ln("self_attn_layer_norm")
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
            shapes[f"{pre}self_attn.{proj}.weight"] = (d, d)
            shapes[f"{pre}self_attn.{proj}.bias"] = (d,)
        shapes[pre + "self_attn.distance_embedding.weight"] = (nrel, d // cfg.num_attention_heads)
        ln("conv_module.layer_norm")
        shapes[pre + "conv_module.pointwise_conv1.weight"] = (2 * d, d, 1)
        shapes[pre + "conv_module.depthwise_conv.weight"] = (d, 1, cfg.conv_depthwise_kernel_size)
        ln("conv_module.depthwise_layer_norm")
        shapes[pre + "conv_module.pointwise_conv2.weight"] = (d, d, 1)
        ln("ffn2_layer_norm")
        ffn("ffn2")
        ln("final_layer_norm")
    return shapes


def n_params(cfg: W2VBertConfig) -> int:
    """Parameters of the encoder, reckoned from the shapes alone."""
    return sum(math.prod(s) for s in param_shapes(cfg).values())


def init_params(cfg: W2VBertConfig, device, seed: int | None = None) -> dict[str, torch.Tensor]:
    """The weights drawn on `device` from a generator seeded with `seed`
    (the config's by default), name by name in param_shapes' order, at the
    published initial scales: the projection's weight and bias uniform in
    +-sqrt(1 / fan_in), the convs Kaiming-normal (std sqrt(2 / fan_in)),
    every other Linear normal with std 0.02 and zero bias,
    distance_embedding standard normal (nn.Embedding), LayerNorms ones and
    zeros."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg.seed if seed is None else seed))
    out = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("feature_projection.projection"):
            bound = math.sqrt(1.0 / cfg.feature_projection_input_dim)
            out[name] = (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound
        elif "layer_norm" in name:
            out[name] = torch.full(shape, 1.0 if leaf == "weight" else 0.0, device=device)
        elif len(shape) == 3:
            std = math.sqrt(2.0 / (shape[1] * shape[2]))
            out[name] = torch.randn(shape, generator=gen, device=device) * std
        elif name.endswith("distance_embedding.weight"):
            out[name] = torch.randn(shape, generator=gen, device=device)
        elif leaf == "weight":
            out[name] = torch.randn(shape, generator=gen, device=device) * 0.02
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ------------------------------------------------------------------ stages

_valid = wavlm._valid  # [B, T] True at each clip's own frames


def _ln(p: dict, name: str, x: torch.Tensor, cfg: W2VBertConfig) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"],
                        cfg.layer_norm_eps)


def project(p: dict, feats: torch.Tensor, cfg: W2VBertConfig) -> torch.Tensor:
    """LayerNorm over the 160 stacked fbank dims, then Linear to hidden."""
    return F.linear(_ln(p, "feature_projection.layer_norm", feats, cfg),
                    p["feature_projection.projection.weight"],
                    p["feature_projection.projection.bias"])


def feed_forward(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Linear(hidden -> intermediate), swish, Linear back."""
    y = F.silu(F.linear(x, p[name + ".intermediate_dense.weight"],
                        p[name + ".intermediate_dense.bias"]))
    return F.linear(y, p[name + ".output_dense.weight"], p[name + ".output_dense.bias"])


def depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] -> the causal depthwise conv [B, T, C] with w [C, 1, K]:
    output t reads inputs t - K + 1 .. t, zeros before the first (cuDNN,
    channels first)."""
    K = w.shape[-1]
    y = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), w, groups=w.shape[0])
    return y.transpose(1, 2)


def conv_module(p: dict, i: int, h: torch.Tensor, valid: torch.Tensor,
                cfg: W2VBertConfig) -> torch.Tensor:
    """Layer i's convolution module on h [B, T, D], channels last: LN, the
    rows past each clip's frames (`valid` [B, T] False) zeroed, the
    pointwise conv to 2 D, GLU, depthwise_conv, LN, swish, the pointwise
    conv to D."""
    pre = LAYER.format(i) + "conv_module."
    x = torch.where(valid[..., None], _ln(p, pre + "layer_norm", h, cfg), 0.0)
    x = F.glu(F.linear(x, p[pre + "pointwise_conv1.weight"][..., 0]), dim=-1)
    x = depthwise_conv(x, p[pre + "depthwise_conv.weight"])
    x = F.silu(_ln(p, pre + "depthwise_layer_norm", x, cfg))
    return F.linear(x, p[pre + "pointwise_conv2.weight"][..., 0])


def distance_index(T: int, left: int, right: int, device=None) -> torch.Tensor:
    """[T, T] row of distance_embedding for query i and key j:
    clamp(j - i, -left, right) + left."""
    t = torch.arange(T, device=device)
    return (t[None, :] - t[:, None]).clamp(-left, right) + left


def rel_key_scores(q: torch.Tensor, dist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """q [B, heads, T, head_dim], D [nrel, head_dim], idx [T, T] -> the
    relative-key term q_i . D[idx[i, j]] / sqrt(head_dim) [B, heads, T, T]:
    each row's nrel products, gathered by distance."""
    table = q @ dist.T / math.sqrt(q.shape[-1])  # [B, heads, T, nrel]
    return torch.gather(table, -1, idx.expand(*q.shape[:2], *idx.shape))


def relkey_attention_plain(p: dict, i: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           frames: torch.Tensor, cfg: W2VBertConfig) -> torch.Tensor:
    """Layer i's attention core in PyTorch: each head's slice of q, k, v
    [B, T, D], the relative-key term and the key mask of each clip's
    `frames` (a clip of no frame attends to its first, so no row of the
    softmax is empty) built whole, softmax(q k^T / sqrt(head_dim) + that)
    v -> [B, T, D]."""
    B, T, D = q.shape
    heads = cfg.num_attention_heads

    def split(y):
        return y.view(B, T, heads, D // heads).transpose(1, 2)

    idx = distance_index(T, cfg.left_max_position_embeddings, cfg.right_max_position_embeddings,
                         q.device)
    qh = split(q)
    bias = rel_key_scores(qh, p[LAYER.format(i) + "self_attn.distance_embedding.weight"], idx)
    mask = wavlm.key_mask(_valid(frames.long(), T) | (torch.arange(T, device=q.device) == 0))
    a = F.scaled_dot_product_attention(qh, split(k), split(v), attn_mask=bias + mask)
    return a.transpose(1, 2).reshape(B, T, D)


def _relkey_attention_cuda(p, i, q, k, v, frames, cfg, pairs=None):
    """The kernel's launch; `pairs`, a CUDA int64 [1] tensor, gets the
    query-key pairs the kernel multiplied added to it."""
    B, T, D = q.shape
    heads = cfg.num_attention_heads
    left, right = cfg.left_max_position_embeddings, cfg.right_max_position_embeddings
    dist = p[LAYER.format(i) + "self_attn.distance_embedding.weight"]
    acts = (q, k, v)
    if (D != heads * ATTN_HEAD_DIM or left < 0 or right < 0 or left + right + 1 > NREL_MAX
            or tuple(dist.shape) != (left + right + 1, ATTN_HEAD_DIM)
            or any(t.shape != q.shape or t.stride(2) != 1 or t.stride(0) % 4 or t.stride(1) % 4
                   or t.data_ptr() % 16 for t in acts)
            or any(t.dtype != torch.float32 or t.device != q.device for t in (*acts, dist))
            or not dist.is_contiguous() or dist.data_ptr() % 16
            or frames.dtype != torch.int32 or frames.shape != (B,) or frames.device != q.device
            or pairs is not None and (pairs.dtype != torch.int64 or pairs.device != q.device)):
        raise ValueError(
            f"relkey_attention kernel needs float32 [B, T, heads x {ATTN_HEAD_DIM}] q, k, v on "
            f"one device (last stride 1, 16-byte rows), a contiguous distance_embedding of at "
            f"most {NREL_MAX} rows of {ATTN_HEAD_DIM} and int32 frames [B]; got {tuple(q.shape)} "
            f"{[(t.dtype, t.stride()) for t in acts]}, distance_embedding {tuple(dist.shape)}, "
            f"frames {frames.dtype} {tuple(frames.shape)}")
    out = torch.empty(B, T, D, device=q.device)
    fn = _build.bind("gated_attention", "relkey_attention_launch", 7, 11)
    ptrs = [t.data_ptr() for t in (*acts, dist, frames, out)]
    ptrs.append(None if pairs is None else pairs.data_ptr())
    strides = [n for t in acts for n in (t.stride(0), t.stride(1))]
    rc = _build.launch(fn, q, *ptrs, B, T, heads, left, right, *strides)
    _build.check(rc, "relkey_attention_launch")
    _LAUNCHES.launches += 1
    return out


def relkey_attention(p: dict, i: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     frames: torch.Tensor, cfg: W2VBertConfig) -> torch.Tensor:
    """Layer i's attention core: the projections q, k, v [B, T, D], `frames`
    [B] each clip's frames (int32 on a CUDA device) -> softmax((q k^T + q
    D[clamp(j - i)]^T) / sqrt(head_dim) + key mask) v [B, T, D].  A CUDA
    tensor launches the relative-key mode of csrc/gated_attention.cu (its
    rows past a clip's frames zero); a CPU tensor runs
    relkey_attention_plain."""
    if q.is_cuda:
        return _relkey_attention_cuda(p, i, q, k, v, frames, cfg)
    if q.device.type == "cpu":
        return relkey_attention_plain(p, i, q, k, v, frames, cfg)
    raise ValueError(f"relkey_attention: no kernel for device {q.device}")


relkey_attention.launches = 0  # kernel launches
# the function that holds the count: a caller may wrap the module's name
# (a tracing span), and the count stays on the function itself
_LAUNCHES = relkey_attention


def conformer_layer(p: dict, i: int, h: torch.Tensor, valid: torch.Tensor, frames: torch.Tensor,
                    cfg: W2VBertConfig) -> torch.Tensor:
    """One Conformer layer: the half-step FFN1, the relative-key attention,
    the convolution module, the half-step FFN2, each residual, then the
    final LayerNorm."""
    pre = LAYER.format(i)
    h = h + 0.5 * feed_forward(p, pre + "ffn1", _ln(p, pre + "ffn1_layer_norm", h, cfg))
    x = _ln(p, pre + "self_attn_layer_norm", h, cfg)
    q, k, v = (F.linear(x, p[f"{pre}self_attn.{name}.weight"], p[f"{pre}self_attn.{name}.bias"])
               for name in ("linear_q", "linear_k", "linear_v"))
    with span("w2v_bert.attention"):
        a = relkey_attention(p, i, q, k, v, frames, cfg)
    h = h + F.linear(a, p[pre + "self_attn.linear_out.weight"], p[pre + "self_attn.linear_out.bias"])
    with span("w2v_bert.conv_module"):
        h = h + conv_module(p, i, h, valid, cfg)
    h = h + 0.5 * feed_forward(p, pre + "ffn2", _ln(p, pre + "ffn2_layer_norm", h, cfg))
    return _ln(p, pre + "final_layer_norm", h, cfg)


def _count(t_len: torch.Tensor, B: int, T: int) -> None:
    t = t_len.cpu().to(torch.int64)
    count("w2v_bert.batches", 1)
    count("w2v_bert.valid_frames", int(t.sum()))
    count("w2v_bert.sent_frames", B * T)
    count("w2v_bert.attn_pairs_valid", int((t * t).sum()))
    count("w2v_bert.attn_pairs_sent", B * T * T)
    count("w2v_bert.attn_pairs_run", wavlm.attn_pairs_run(t))


def encode(p: dict, audio: torch.Tensor, lengths: torch.Tensor,
           cfg: W2VBertConfig) -> torch.Tensor:
    """audio [B, N] (zero-padded), lengths [B] samples -> the embeddings
    [B, hidden_size]: the mean of the last hidden state over each clip's
    frames (zero for a clip too short to give one)."""
    B, N = audio.shape
    lengths = lengths.to(audio.device).long()
    T = frame_lengths(N)
    if T <= 0:
        return audio.new_zeros(B, cfg.hidden_size)
    with span("w2v_bert.encode"):
        with span("w2v_bert.fbank"):
            feats, t_len = fbank.features(audio, lengths)
        if tracing():
            _count(t_len, B, T)
        valid = _valid(t_len, T)
        h = torch.where(valid[..., None], project(p, feats, cfg), 0.0)
        # the attention reads each clip's frames; a clip of no frame attends
        # to its first (padded) one there, and its embedding is zeroed below
        frames = t_len.to(torch.int32)
        for i in range(cfg.num_hidden_layers):
            h = conformer_layer(p, i, h, valid, frames, cfg)
        summed = torch.where(valid[..., None], h, 0.0).sum(1)
        return summed / t_len.clamp(min=1).to(h.dtype)[:, None]


# ------------------------------------------------------- weights per device

_ENCODERS: dict[W2VBertConfig, wavlm.Encoder] = {}
_ENCODERS_LOCK = threading.Lock()


def encoder_for(cfg: W2VBertConfig) -> wavlm.Encoder:
    """The process's Encoder of `cfg` (made at the first call): its
    weights loaded or drawn (init_params) on the first device, one copy per
    device."""
    with _ENCODERS_LOCK:
        return _ENCODERS.setdefault(cfg, wavlm.Encoder(cfg))


def release() -> None:
    """Drop every Encoder's weights (the next call loads or draws them
    again)."""
    with _ENCODERS_LOCK:
        _ENCODERS.clear()
    fbank.mel_filters.cache_clear()
    fbank.povey_window.cache_clear()


def batch_fn_for(cfg: W2VBertConfig, text_len: int = 5):
    """`batch_fn(audio [B, N], lengths [B]) -> [B, hidden_size + text_len]`
    on audio's device: the embeddings (encode, with that device's weights;
    in row chunks of at most wavlm.SAMPLE_BUDGET samples), then text_len
    zero placeholders.  It carries a row's samples (`frame_stride`, 2 x
    160), by which ops/frontend.run_bucketed pads its batches only to their
    longest clip: a clip's embedding does not depend on N."""
    enc = encoder_for(cfg)

    def batch_fn(audio, lengths):
        p = enc.params(audio.device)
        B, N = audio.shape
        rows = max(1, wavlm.SAMPLE_BUDGET // max(N, 1))
        parts = [encode(p, audio[s : s + rows], lengths[s : s + rows], cfg)
                 for s in range(0, B, rows)]
        emb = parts[0] if len(parts) == 1 else torch.cat(parts)
        return torch.cat([emb, emb.new_zeros(B, text_len)], dim=1)

    batch_fn.frame_stride = fbank.ROW_SAMPLES
    return batch_fn
