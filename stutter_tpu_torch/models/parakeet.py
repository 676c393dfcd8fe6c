"""Parakeet-CTC-1.1B's FastConformer encoder as a clip embedding encoder:
raw 16 kHz audio -> one pooled vector a recording (1024 dims at the
published widths), the front end of the embedding features
(config.EmbeddingFeatureConfig with a ParakeetConfig,
ops/frontend.batch_extractor_for).

The equations are those of transformers' modeling_parakeet.py
(ParakeetEncoder, no CTC head), in inference, over the input of
ParakeetFeatureExtractor:

  * the input: ops/fbank.parakeet_features, 80 slaney log-mel bins at
    100 Hz, each clip normalised over its own L // 160 frames;
  * the stem (`subsample`), on the padded batch [B, 1, F, 80]: a Conv2d
    1 -> C (3 x 3, stride 2, padding 1), ReLU, then twice a depthwise
    3 x 3 stride-2 conv, a pointwise 1 x 1 conv and ReLU; after every
    conv the time positions past the clip's reduced length are zeroed;
    the [C, T, 10] output flattened channel-major to C x 10 a frame, then
    Linear(C x 10 -> hidden), x sqrt(hidden) when `scale_input`;
  * num_hidden_layers Conformer blocks, each:
      h += 1/2 FFN1(LN(h));
      h += o_proj(attention(LN(h))), Transformer-XL's relative attention
           softmax(((q_i + u) . k_j + (q_i + v) . P[i - j]) / sqrt(d)) v
           over the clip's own frames, u and v the layer's bias_u and
           bias_v, P[delta] = relative_k_proj(s(delta)), s the interleaved
           sinusoid of the signed distance (xl_attention: on a CUDA device
           the third mode of csrc/gated_attention.cu, no [T, 2T - 1]
           tensor; the table P once a layer an encode call over every
           distance of the call's longest clip, one SGEMM);
      h += conv_module(LN(h)): a pointwise conv to 2 x hidden with bias,
           GLU, a centred depthwise conv of conv_kernel_size taps with bias
           (the frames outside a clip count as zero), BatchNorm with its
           running statistics, SiLU, a pointwise conv with bias (the GLU,
           the depthwise conv, BatchNorm and SiLU: on a CUDA device one
           launch of csrc/glu_depthwise.cu, BatchNorm folded into its taps
           and bias when the weights are loaded);
      h += 1/2 FFN2(LN(h)), then LN;
    each FFN Linear(hidden -> intermediate), SiLU, Linear back, with
    biases;
  * the embedding: the mean of the last hidden state over a clip's frames
    (zero for a clip too short to give one).

A clip of L samples has T = L // 160 log-mel frames and, after the stem's
three halvings, (T + 1) // 2 three times: 12.5 frames a second.  The stem
runs on the padded batch; its rows are then packed (Clips, as in
models/w2v_bert.py): the blocks run on [R, hidden], R the clips' frames,
and every row-wise product, the attention and the conv module see only
each clip's own frames.  So a recording's embedding is the same alone and
inside a batch, and a recording of any length up to
max_position_embeddings frames goes through whole.

Weights live in a dict under the checkpoint's parameter names
(param_shapes, BatchNorm's running statistics among them), so a
checkpoint saved by persist.save_wavlm loads by name; without one they
are drawn from the config's seed (init_params).  The Encoder adds the
folded depthwise taps and bias to each device's copy (fold_batchnorm).

Traced (utils.profiling), an `encode` call is the span `parakeet.encode`,
holding `parakeet.fbank`, `parakeet.subsample` and, a layer,
`parakeet.pos` (the positional projection), `parakeet.attention` and
`parakeet.conv_module`, and counts `parakeet.batches`, `valid_frames`,
`sent_frames` (the rows the blocks ran on: R), `attn_pairs_valid` and
`attn_pairs_sent` (sum of T_i^2), `attn_pairs_run` (the pairs the
attention kernel multiplies), `pos_products_run` (the (row, distance)
products of its positional half) and `pos_rows` (the rows of one layer's
positional table: 2 T_max - 1).
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from stutter_tpu_torch import _build
from stutter_tpu_torch.config import ParakeetConfig
from stutter_tpu_torch.models import w2v_bert, wavlm
from stutter_tpu_torch.models.w2v_bert import Clips, pack_index, row_starts
from stutter_tpu_torch.ops import fbank
from stutter_tpu_torch.utils.profiling import count, span, tracing

ATTN_HEAD_DIM = 128  # the attention kernel's third mode's head width
ATTN_KEYS = 32  # its keys a tile, and distances a block of its positional half
ATTN_BLOCKS_PER_SM = 2  # its blocks an SM holds (xl_blocks_per_sm; a card test)
CONV_TAPS = 9  # the centred depthwise conv's taps the kernel takes
CONV_CHANNELS = w2v_bert.CONV_CHANNELS
LN_EPS = 1e-5  # nn.LayerNorm's default, as the blocks build them
BN_EPS = 1e-5  # nn.BatchNorm1d's default
POS_BASE = 10000.0
LAYER = "layers.{}."
BUFFERS = ("running_mean", "running_var")  # BatchNorm's statistics: not parameters
FOLDED = "conv.depthwise_folded."  # the Encoder's folded taps and bias, a layer
# samples a batch_fn call encodes at once at most: a batch of more rows x
# samples is encoded in row chunks (8 recordings of 400 s)
SAMPLE_BUDGET = 8 * 5000 * 8 * fbank.HOP


def frame_lengths(lengths, cfg: ParakeetConfig | None = None):
    """Encoder frames of clips of `lengths` samples (ints or an integer
    tensor): L // 160, then (T + 1) // 2 for each of the stem's
    log2(subsampling_factor) strided convs."""
    n = int(math.log2((cfg or ParakeetConfig()).subsampling_factor))
    return fbank.parakeet_frame_lengths(lengths, n)


def frame_samples(cfg: ParakeetConfig) -> int:
    """Samples an encoder frame advances: 160 x subsampling_factor."""
    return fbank.HOP * cfg.subsampling_factor


def _stem_convs(cfg: ParakeetConfig) -> int:
    return int(math.log2(cfg.subsampling_factor))


def param_shapes(cfg: ParakeetConfig) -> dict[str, tuple]:
    """Every parameter's (and BatchNorm statistic's) checkpoint name and
    shape, in the order they are drawn."""
    d, f, h = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    c, k = cfg.subsampling_conv_channels, cfg.subsampling_conv_kernel_size
    n_conv = _stem_convs(cfg)
    shapes: dict[str, tuple] = {"subsampling.layers.0.weight": (c, 1, k, k),
                                "subsampling.layers.0.bias": (c,)}
    for j in range(n_conv - 1):
        dw, pw = 2 + 3 * j, 3 + 3 * j
        shapes[f"subsampling.layers.{dw}.weight"] = (c, 1, k, k)
        shapes[f"subsampling.layers.{dw}.bias"] = (c,)
        shapes[f"subsampling.layers.{pw}.weight"] = (c, c, 1, 1)
        shapes[f"subsampling.layers.{pw}.bias"] = (c,)
    mels = cfg.num_mel_bins // cfg.subsampling_conv_stride ** n_conv
    shapes["subsampling.linear.weight"] = (d, c * mels)
    shapes["subsampling.linear.bias"] = (d,)
    for i in range(cfg.num_hidden_layers):
        pre = LAYER.format(i)

        def norm(name):
            shapes[f"{pre}{name}.weight"] = (d,)
            shapes[f"{pre}{name}.bias"] = (d,)

        def ffn(name):
            shapes[f"{pre}{name}.linear1.weight"] = (f, d)
            shapes[f"{pre}{name}.linear1.bias"] = (f,)
            shapes[f"{pre}{name}.linear2.weight"] = (d, f)
            shapes[f"{pre}{name}.linear2.bias"] = (d,)

        norm("norm_feed_forward1")
        ffn("feed_forward1")
        norm("norm_self_att")
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            shapes[f"{pre}self_attn.{proj}.weight"] = (d, d)
            shapes[f"{pre}self_attn.{proj}.bias"] = (d,)
        shapes[pre + "self_attn.relative_k_proj.weight"] = (d, d)
        shapes[pre + "self_attn.bias_u"] = (h, d // h)
        shapes[pre + "self_attn.bias_v"] = (h, d // h)
        norm("norm_conv")
        shapes[pre + "conv.pointwise_conv1.weight"] = (2 * d, d, 1)
        shapes[pre + "conv.pointwise_conv1.bias"] = (2 * d,)
        shapes[pre + "conv.depthwise_conv.weight"] = (d, 1, cfg.conv_kernel_size)
        shapes[pre + "conv.depthwise_conv.bias"] = (d,)
        for leaf in ("weight", "bias", *BUFFERS):
            shapes[f"{pre}conv.norm.{leaf}"] = (d,)
        shapes[pre + "conv.pointwise_conv2.weight"] = (d, d, 1)
        shapes[pre + "conv.pointwise_conv2.bias"] = (d,)
        norm("norm_feed_forward2")
        ffn("feed_forward2")
        norm("norm_out")
    return shapes


def n_params(cfg: ParakeetConfig) -> int:
    """Parameters of the encoder, reckoned from the shapes alone
    (BatchNorm's running statistics are buffers, not counted)."""
    return sum(math.prod(s) for name, s in param_shapes(cfg).items()
               if name.rsplit(".", 1)[-1] not in BUFFERS)


def init_params(cfg: ParakeetConfig, device, seed: int | None = None) -> dict[str, torch.Tensor]:
    """The weights drawn on `device` from a generator seeded with `seed`
    (the config's by default), name by name in param_shapes' order, at the
    published initial scales (transformers' _init_weights): every Linear
    and bias_u / bias_v normal with std 0.02, the convs Kaiming-normal
    (std sqrt(2 / fan_in), PyTorch's scale: 0.02 would shrink the stem's
    signal some 10^4-fold), every bias zero, LayerNorm and BatchNorm ones
    and zeros, the running variance one."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg.seed if seed is None else seed))
    out = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if ".norm" in name or name.startswith("norm") or leaf == "running_var":
            one = leaf in ("weight", "running_var")
            out[name] = torch.full(shape, 1.0 if one else 0.0, device=device)
        elif leaf in ("bias_u", "bias_v") or len(shape) == 2:
            out[name] = torch.randn(shape, generator=gen, device=device) * 0.02
        elif len(shape) >= 3:
            std = math.sqrt(2.0 / math.prod(shape[1:]))
            out[name] = torch.randn(shape, generator=gen, device=device) * std
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def fold_batchnorm(p: dict, cfg: ParakeetConfig) -> dict:
    """p with each layer's BatchNorm (eval: its running statistics) folded
    into the depthwise conv: taps w s and bias (b - mean) s + beta, s =
    gamma / sqrt(var + eps), under FOLDED's names ([D, K] and [D]); p
    itself, once they are there."""
    for i in range(cfg.num_hidden_layers):
        pre = LAYER.format(i)
        if pre + FOLDED + "weight" in p:
            continue
        bn = pre + "conv.norm."
        s = p[bn + "weight"] / torch.sqrt(p[bn + "running_var"] + BN_EPS)
        w = p[pre + "conv.depthwise_conv.weight"][:, 0, :]
        p[pre + FOLDED + "weight"] = (w * s[:, None]).contiguous()
        p[pre + FOLDED + "bias"] = ((p[pre + "conv.depthwise_conv.bias"] - p[bn + "running_mean"])
                                    * s + p[bn + "bias"])
    return p


# ------------------------------------------------------------------ stages

def _ln(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], LN_EPS)


def _time_mask(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x [B, C, T, M] with the time positions at or past t[b] zeroed."""
    keep = torch.arange(x.shape[2], device=x.device)[None, :] < t[:, None]
    return x * keep[:, None, :, None]


def subsample(p: dict, feats: torch.Tensor, n: torch.Tensor,
              cfg: ParakeetConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The stem on the padded batch: feats [B, F, mels] (zero past each
    clip's n[b] frames) -> ([B, T, C x mels / 8], each conv's output
    flattened channel-major a frame; the encoder frames [B])."""
    k, s = cfg.subsampling_conv_kernel_size, cfg.subsampling_conv_stride
    pad, c = (k - 1) // 2, cfg.subsampling_conv_channels

    def strided(x, name, groups, t):
        x = F.conv2d(x, p[name + ".weight"], p[name + ".bias"], stride=s, padding=pad,
                     groups=groups)
        t = (t + 2 * pad - k) // s + 1
        return _time_mask(x, t), t

    x, t = strided(feats[:, None], "subsampling.layers.0", 1, n)
    x = F.relu(x)
    for j in range(_stem_convs(cfg) - 1):
        dw, pw = f"subsampling.layers.{2 + 3 * j}", f"subsampling.layers.{3 + 3 * j}"
        x, t = strided(x, dw, c, t)
        x = F.relu(_time_mask(F.conv2d(x, p[pw + ".weight"], p[pw + ".bias"]), t))
    return x.transpose(1, 2).flatten(2), t


def feed_forward(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Linear(hidden -> intermediate), SiLU, Linear back, with biases."""
    y = F.silu(F.linear(x, p[name + ".linear1.weight"], p[name + ".linear1.bias"]))
    return F.linear(y, p[name + ".linear2.weight"], p[name + ".linear2.bias"])


def sinusoids(T: int, D: int, device) -> torch.Tensor:
    """[2T - 1, D]: row T - 1 + delta holds s(delta), delta = -(T - 1) ..
    T - 1, with s(delta)[2k] = sin(delta w_k), s(delta)[2k + 1] =
    cos(delta w_k), w_k = 10000^(-2k / D), in float32 as transformers
    computes them."""
    inv = 1.0 / (POS_BASE ** (torch.arange(0, D, 2, dtype=torch.int64, device=device).float() / D))
    ang = torch.arange(1 - T, T, device=device).float()[:, None] * inv[None, :]
    return torch.stack([ang.sin(), ang.cos()], dim=-1).reshape(2 * T - 1, D)


def position_table(p: dict, i: int, sin: torch.Tensor) -> torch.Tensor:
    """Layer i's relative_k_proj over every distance: [2T - 1, D], row T - 1
    + delta the projected s(delta) -- one SGEMM."""
    return F.linear(sin, p[LAYER.format(i) + "self_attn.relative_k_proj.weight"])


def xl_attention_plain(p: dict, i: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos: torch.Tensor, clips: Clips, cfg: ParakeetConfig) -> torch.Tensor:
    """Layer i's attention core in PyTorch: each head's slice of the packed
    q, k, v [R, D] laid out [B, T] (T the longest clip), the positional
    term (q + v) P^T [B, heads, T, 2T - 1] built whole and shifted to
    [B, heads, T, T] by i - j, the key mask of each clip's frames, then
    SDPA of q + u against k and v, packed back -> [R, D].  `pos` is the
    layer's position_table over at least T's distances."""
    R, D = q.shape
    B, T = len(clips.frames), clips.longest
    if R == 0:
        return q.new_zeros(0, D)
    heads = cfg.num_attention_heads
    dh = D // heads
    idx = pack_index(clips.frames, T).to(q.device)

    def split(y):
        y = y.new_zeros(B * T, D).index_copy_(0, idx, y)
        return y.view(B, T, heads, dh).transpose(1, 2)

    qu, bias = xl_terms(p, i, split(q), pos, clips.frames.to(q.device))
    a = F.scaled_dot_product_attention(qu, split(k), split(v), attn_mask=bias)
    return a.transpose(1, 2).reshape(B * T, D).index_select(0, idx)


def xl_terms(p: dict, i: int, qh: torch.Tensor, pos: torch.Tensor,
             frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """qh [B, heads, T, head_dim] (each clip's rows laid out [B, T]), the
    layer's position_table and each clip's frames (on qh's device) -> (q +
    u, the positional term (q + v) P[i - j]^T / sqrt(head_dim) plus the key
    mask [B, heads, T, T]): the product with every distance of the table
    [B, heads, T, 2T - 1] built whole, then shifted to i - j."""
    B, heads, T, dh = qh.shape
    pre = LAYER.format(i) + "self_attn."
    Tt = (pos.shape[0] + 1) // 2
    table = pos[Tt - T : Tt + T - 1].view(2 * T - 1, heads, dh).transpose(0, 1)  # [H, 2T-1, dh]
    bd = (qh + p[pre + "bias_v"][None, :, None, :]) @ table.transpose(1, 2)[None]
    t = torch.arange(T, device=qh.device)
    shift = (t[:, None] - t[None, :] + T - 1).expand(B, heads, T, T)
    bd = torch.gather(bd, -1, shift) / math.sqrt(dh)
    # a clip of no frame has no row, but its padded rows' softmax must not
    # be empty: their first key stays unmasked
    mask = wavlm.key_mask(w2v_bert._valid(frames, T) | (t == 0))
    return qh + p[pre + "bias_u"][None, :, None, :], bd + mask


def _xl_attention_cuda(p, i, q, k, v, pos, clips, cfg, pairs=None):
    """The kernel's launch; `pairs`, a CUDA int64 [2] tensor, gets the
    query-key pairs the kernel multiplied and the (row, distance) products
    of its positional half added to it."""
    R, D = q.shape[0], q.shape[-1]
    heads = cfg.num_attention_heads
    pre = LAYER.format(i) + "self_attn."
    bu, bv = p[pre + "bias_u"], p[pre + "bias_v"]
    offsets = clips.offsets
    acts = (q, k, v)
    if (q.dim() != 2 or D != heads * ATTN_HEAD_DIM or pos.dim() != 2 or pos.shape[1] != D
            or pos.shape[0] % 2 != 1 or (pos.shape[0] + 1) // 2 < clips.longest
            or any(t.shape != q.shape for t in acts)
            or any(t.stride(-1) != 1 or t.stride(0) % 4 or t.data_ptr() % 16 for t in (*acts, pos))
            or any(t.dtype != torch.float32 or t.device != q.device for t in (*acts, pos, bu, bv))
            or any(tuple(b.shape) != (heads, ATTN_HEAD_DIM) or not b.is_contiguous()
                   or b.data_ptr() % 16 for b in (bu, bv))
            or offsets.dtype != torch.int32 or offsets.shape != (len(clips.frames) + 1,)
            or offsets.device != q.device or R != int(clips.frames.sum())
            or pairs is not None and (pairs.dtype != torch.int64 or pairs.shape != (2,)
                                      or pairs.device != q.device)):
        raise ValueError(
            f"xl_attention kernel needs float32 packed [R, heads x {ATTN_HEAD_DIM}] q, k, v on "
            f"one device (last stride 1, 16-byte rows), a [2 T - 1, heads x {ATTN_HEAD_DIM}] "
            f"position table over the longest clip's distances, contiguous [heads, "
            f"{ATTN_HEAD_DIM}] bias_u and bias_v and int32 offsets [B + 1] of R rows; got "
            f"{tuple(q.shape)} {[(t.dtype, t.stride()) for t in acts]}, table "
            f"{tuple(pos.shape)} {pos.stride()}, biases {tuple(bu.shape)} {tuple(bv.shape)}, "
            f"offsets {offsets.dtype} {tuple(offsets.shape)}, frames summed "
            f"{int(clips.frames.sum())}")
    out = torch.empty(R, D, device=q.device)
    if R == 0:
        return out
    fn = _build.bind("gated_attention", "xl_attention_launch", 9, 8)
    ptrs = [t.data_ptr() for t in (*acts, bu, bv, pos, offsets, out)]
    ptrs.append(None if pairs is None else pairs.data_ptr())
    rc = _build.launch(fn, q, *ptrs, len(clips.frames), clips.longest, heads,
                       (pos.shape[0] + 1) // 2, pos.stride(0), *(t.stride(0) for t in acts))
    _build.check(rc, "xl_attention_launch")
    _LAUNCHES.launches += 1
    return out


def xl_attention(p: dict, i: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor, clips: Clips, cfg: ParakeetConfig) -> torch.Tensor:
    """Layer i's attention core over packed rows: the projections q, k, v
    [R, D], the layer's position_table `pos`, `clips` where each clip's rows
    lie -> softmax(((q + u) k^T + (q + v) P[i - j]^T) / sqrt(head_dim)) v
    [R, D], each clip's rows over its own keys.  A CUDA tensor launches the
    Transformer-XL mode of csrc/gated_attention.cu; a CPU tensor runs
    xl_attention_plain."""
    if q.is_cuda:
        return _xl_attention_cuda(p, i, q, k, v, pos, clips, cfg)
    if q.device.type == "cpu":
        return xl_attention_plain(p, i, q, k, v, pos, clips, cfg)
    raise ValueError(f"xl_attention: no kernel for device {q.device}")


xl_attention.launches = 0  # kernel launches
# the function that holds the count: a caller may wrap the module's name
# (a tracing span), and the count stays on the function itself
_LAUNCHES = xl_attention


def xl_blocks_per_sm(device) -> int:
    """Blocks of the attention kernel's Transformer-XL mode one SM of this
    CUDA device holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the
    kernel's shared memory and registers)."""
    import ctypes

    blocks = ctypes.c_int(0)
    fn = _build.bind("gated_attention", "xl_attention_occupancy", 1, 0)
    _build.check(_build.launch(fn, torch.empty(0, device=device), ctypes.addressof(blocks)),
                 "xl_attention_occupancy")
    return blocks.value


def centred_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, clips: Clips) -> torch.Tensor:
    """x [R, C] packed rows -> the centred depthwise conv [R, C] with taps w
    [C, K] (K odd) and bias b [C]: row r reads rows r - (K - 1) / 2 .. r +
    (K - 1) / 2 of its own clip, the rows outside it counting as zero."""
    R, K = x.shape[0], w.shape[-1]
    half = (K - 1) // 2
    start = row_starts(clips, x.device)
    end = start + torch.from_numpy(np.repeat(clips.frames.numpy(), clips.frames.numpy())).to(x.device)
    r = torch.arange(R, device=x.device)
    y = x * w[:, half] + b
    for d in range(1, min(half, R - 1) + 1):
        before = (r[d:] - d >= start[d:])[:, None]  # row r - d, for rows r >= d
        y[d:] += torch.where(before, x[:-d], 0.0) * w[:, half - d]
        after = (r[:-d] + d < end[:-d])[:, None]  # row r + d, for rows r < R - d
        y[:-d] += torch.where(after, x[d:], 0.0) * w[:, half + d]
    return y


def glu_conv_silu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        clips: Clips) -> torch.Tensor:
    """x [R, 2 C] packed rows -> SiLU(centred_conv(GLU(x))) [R, C], in
    PyTorch."""
    return F.silu(centred_conv(F.glu(x, dim=-1), w, b, clips))


def _glu_conv_silu_cuda(x, w, b, clips, out=None):
    """The kernel's launch; `out`, if given, a float32 [>= R, C] buffer it
    writes its R rows into (the returned view)."""
    R, C = x.shape[0], x.shape[-1] // 2
    offsets = clips.offsets
    if (x.dim() != 2 or C % CONV_CHANNELS or tuple(w.shape) != (C, CONV_TAPS)
            or tuple(b.shape) != (C,)
            or any(t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous()
                   or t.data_ptr() % 16 for t in (x, w, b))
            or offsets.dtype != torch.int32 or offsets.shape != (len(clips.frames) + 1,)
            or offsets.device != x.device or R != int(clips.frames.sum())
            or out is not None and (out.dtype != torch.float32 or out.device != x.device
                                    or not out.is_contiguous() or out.dim() != 2
                                    or out.shape[0] < R or out.shape[1] != C)):
        raise ValueError(
            f"glu_conv_silu kernel needs a contiguous float32 [R, 2 C] x (C a multiple of "
            f"{CONV_CHANNELS}, 16-byte aligned), contiguous [C, {CONV_TAPS}] taps and [C] bias "
            f"on its device and int32 offsets [B + 1] of R rows; got x {tuple(x.shape)} "
            f"{x.dtype} {x.stride()}, taps {tuple(w.shape)} {w.dtype}, bias {tuple(b.shape)}, "
            f"offsets {offsets.dtype} {tuple(offsets.shape)}, frames summed "
            f"{int(clips.frames.sum())}")
    out = torch.empty(R, C, device=x.device) if out is None else out
    if R:
        fn = _build.bind("glu_depthwise", "glu_conv_silu_launch", 5, 3)
        rc = _build.launch(fn, x, x.data_ptr(), w.data_ptr(), b.data_ptr(), offsets.data_ptr(),
                           out.data_ptr(), R, C, len(clips.frames))
        _build.check(rc, "glu_conv_silu_launch")
        glu_conv_silu.launches += 1
    return out[:R]


def glu_conv_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, clips: Clips) -> torch.Tensor:
    """The conv module's core: x [R, 2 C] packed rows (the first pointwise
    conv's output, its bias in), the folded taps w [C, K] and bias b [C] ->
    SiLU(the centred depthwise conv of GLU(x) within each clip) [R, C].  A
    CUDA tensor launches csrc/glu_depthwise.cu's centred instantiation (K =
    9 taps); a CPU tensor runs glu_conv_silu_plain."""
    if x.is_cuda:
        return _glu_conv_silu_cuda(x, w, b, clips)
    if x.device.type == "cpu":
        return glu_conv_silu_plain(x, w, b, clips)
    raise ValueError(f"glu_conv_silu: no kernel for device {x.device}")


glu_conv_silu.launches = 0  # kernel launches


def conv_module(p: dict, i: int, x: torch.Tensor, clips: Clips,
                cfg: ParakeetConfig) -> torch.Tensor:
    """Layer i's convolution module on the packed rows x [R, D] (the
    block's LN already applied), channels last: the pointwise conv to 2 D,
    glu_conv_silu (GLU, the centred depthwise conv within each clip with
    BatchNorm folded in, SiLU), the pointwise conv to D."""
    pre = LAYER.format(i) + "conv."
    y = F.linear(x, p[pre + "pointwise_conv1.weight"][..., 0], p[pre + "pointwise_conv1.bias"])
    y = glu_conv_silu(y, p[LAYER.format(i) + FOLDED + "weight"],
                      p[LAYER.format(i) + FOLDED + "bias"], clips)
    return F.linear(y, p[pre + "pointwise_conv2.weight"][..., 0], p[pre + "pointwise_conv2.bias"])


def conformer_block(p: dict, i: int, h: torch.Tensor, sin: torch.Tensor, clips: Clips,
                    cfg: ParakeetConfig) -> torch.Tensor:
    """One block on the packed rows h [R, D]: the half-step FFN1, the
    relative attention, the conv module, the half-step FFN2, each residual,
    then the block's LayerNorm.  `sin` is the call's sinusoids."""
    pre = LAYER.format(i)
    h = h + 0.5 * feed_forward(p, pre + "feed_forward1", _ln(p, pre + "norm_feed_forward1", h))
    x = _ln(p, pre + "norm_self_att", h)
    q, k, v = (F.linear(x, p[f"{pre}self_attn.{name}.weight"], p[f"{pre}self_attn.{name}.bias"])
               for name in ("q_proj", "k_proj", "v_proj"))
    with span("parakeet.pos"):
        pos = position_table(p, i, sin)
    with span("parakeet.attention"):
        a = xl_attention(p, i, q, k, v, pos, clips, cfg)
    h = h + F.linear(a, p[pre + "self_attn.o_proj.weight"], p[pre + "self_attn.o_proj.bias"])
    with span("parakeet.conv_module"):
        h = h + conv_module(p, i, _ln(p, pre + "norm_conv", h), clips, cfg)
    h = h + 0.5 * feed_forward(p, pre + "feed_forward2", _ln(p, pre + "norm_feed_forward2", h))
    return _ln(p, pre + "norm_out", h)


def attn_pairs_run(frames) -> int:
    """Query-key pairs a head the attention kernel multiplies for clips of
    these frame counts: each clip's rows in whole warps of 16 by its keys in
    whole groups of 8 (the last key tile multiplies only the groups that
    hold a key), a clip of no frame none."""
    return sum(-(-t // 16) * 16 * -(-t // 8) * 8 for t in torch.as_tensor(frames).tolist())


def pos_products_run(frames) -> int:
    """(row, distance) products a head the kernel's positional half computes
    for clips of these frame counts: each clip's rows in whole warps of 16
    by its positional blocks of ATTN_KEYS distances, one a key tile and the
    64 distances above the query tile's first row, a clip of no frame
    none."""
    return sum(-(-t // 16) * 16 * (-(-t // ATTN_KEYS) * ATTN_KEYS + 64)
               for t in torch.as_tensor(frames).tolist())


def _count(frames: list, T: int) -> None:
    """The counters of one encode call, in plain Python."""
    pairs = sum(t * t for t in frames)
    count("parakeet.batches", 1)
    count("parakeet.valid_frames", sum(frames))
    count("parakeet.sent_frames", sum(frames))
    count("parakeet.attn_pairs_valid", pairs)
    count("parakeet.attn_pairs_sent", pairs)
    count("parakeet.attn_pairs_run", attn_pairs_run(frames))
    count("parakeet.pos_products_run", pos_products_run(frames))
    count("parakeet.pos_rows", 2 * T - 1)


def encode(p: dict, audio: torch.Tensor, lengths: torch.Tensor,
           cfg: ParakeetConfig) -> torch.Tensor:
    """audio [B, N] (zero-padded), lengths [B] samples -> the embeddings
    [B, hidden_size]: the mean of the last hidden state over each clip's
    frames (zero for a clip too short to give one).  The fbank and the stem
    run on the padded batch; the stem's rows past each clip's frames are
    dropped, and the blocks run on the clips' frames packed.  `p` holds the
    folded BatchNorm (fold_batchnorm)."""
    B, N = audio.shape
    T = frame_lengths(N, cfg)
    if T <= 0:
        return audio.new_zeros(B, cfg.hidden_size)
    if T > cfg.max_position_embeddings:
        raise ValueError(f"parakeet: {T} frames exceed max_position_embeddings "
                         f"{cfg.max_position_embeddings}")
    frames = frame_lengths(lengths.cpu().long(), cfg).clamp(max=T).numpy()
    # the stem's output rows a clip: the 1 + N // 160 log-mel frames of
    # the padded batch, halved as the clips' are (one more than T at most)
    rows = frame_lengths(N + fbank.HOP, cfg)
    up = torch.from_numpy(np.concatenate([w2v_bert._offsets(frames),
                                          w2v_bert._pack_index(frames, rows).astype(np.int32)]))
    up = up.to(audio.device)
    clips = Clips(up[: B + 1], torch.from_numpy(frames))
    idx = up[B + 1 :]
    with span("parakeet.encode"):
        if tracing():
            _count(frames.tolist(), clips.longest)
        if not len(idx):
            return audio.new_zeros(B, cfg.hidden_size)
        with span("parakeet.fbank"):
            feats, n = fbank.parakeet_features(audio, lengths.to(audio.device).long())
        with span("parakeet.subsample"):
            x, _ = subsample(p, feats, n, cfg)
            h = F.linear(x.reshape(B * x.shape[1], -1).index_select(0, idx),
                         p["subsampling.linear.weight"], p["subsampling.linear.bias"])
            if cfg.scale_input:
                h = h * math.sqrt(cfg.hidden_size)
        sin = sinusoids(clips.longest, cfg.hidden_size, audio.device)
        for i in range(cfg.num_hidden_layers):
            h = conformer_block(p, i, h, sin, clips, cfg)
        # each clip's rows summed in order; a clip of no row sums to zero
        summed = torch.segment_reduce(h, "sum", offsets=clips.offsets, axis=0, unsafe=True)
        return summed / clips.offsets.diff().clamp(min=1).to(h.dtype)[:, None]


# ------------------------------------------------------- weights per device

class Encoder(wavlm.Encoder):
    """wavlm.Encoder's weights per device, each copy with its BatchNorm
    folded into the depthwise convs (fold_batchnorm) the first time it is
    asked for."""

    def params(self, device) -> dict[str, torch.Tensor]:
        p = super().params(device)
        with self.lock:
            return fold_batchnorm(p, self.cfg)


_ENCODERS: dict[ParakeetConfig, Encoder] = {}
_ENCODERS_LOCK = threading.Lock()


def encoder_for(cfg: ParakeetConfig) -> Encoder:
    """The process's Encoder of `cfg` (made at the first call)."""
    with _ENCODERS_LOCK:
        return _ENCODERS.setdefault(cfg, Encoder(cfg))


def release() -> None:
    """Drop every Encoder's weights (the next call loads or draws them
    again)."""
    with _ENCODERS_LOCK:
        _ENCODERS.clear()
    fbank.slaney_filters.cache_clear()
    fbank.hann_window_centred.cache_clear()


def batch_fn_for(cfg: ParakeetConfig, text_len: int = 5):
    """`batch_fn(audio [B, N], lengths [B]) -> [B, hidden_size + text_len]`
    on audio's device: the embeddings (encode, with that device's weights;
    in row chunks of at most SAMPLE_BUDGET samples), then text_len zero
    placeholders.  It carries an encoder frame's samples (`frame_stride`,
    1280), by which ops/frontend.run_bucketed pads its batches only to
    their longest clip, and the longest clip it takes whole
    (`max_samples`: max_position_embeddings frames), to which
    run_bucketed cuts a longer one."""
    enc = encoder_for(cfg)

    def batch_fn(audio, lengths):
        p = enc.params(audio.device)
        B, N = audio.shape
        rows = max(1, SAMPLE_BUDGET // max(N, 1))
        parts = [encode(p, audio[s : s + rows], lengths[s : s + rows], cfg)
                 for s in range(0, B, rows)]
        emb = parts[0] if len(parts) == 1 else torch.cat(parts)
        return torch.cat([emb, emb.new_zeros(B, text_len)], dim=1)

    batch_fn.frame_stride = frame_samples(cfg)
    batch_fn.max_samples = cfg.max_position_embeddings * frame_samples(cfg)
    return batch_fn
