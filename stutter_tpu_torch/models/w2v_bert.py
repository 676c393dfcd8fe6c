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
  * num_hidden_layers Conformer layers, each:
      h += 1/2 FFN1(LN(h));
      h += out_proj(attention(LN(h))), the relative-key attention
           softmax((q k^T + q D[clamp(j - i, -left, right) + left]^T) /
           sqrt(head_dim)) v over the clip's own frames, D the layer's
           distance_embedding shared by the heads (relkey_attention: on a
           CUDA device the relative-key mode of csrc/gated_attention.cu,
           with no [T, T] tensor);
      h += conv_module(h): LN, a pointwise conv to 2 x hidden without
           bias, GLU, a causal depthwise conv of conv_depthwise_kernel_size
           taps (no bias; the frames before a clip's first count as zero),
           LN, swish, a pointwise conv without bias (the GLU and the
           depthwise conv: on a CUDA device one launch of
           csrc/glu_depthwise.cu);
      h += 1/2 FFN2(LN(h)), then the layer's final LN;
    each FFN Linear(hidden -> intermediate), swish, Linear back;
  * the embedding: the mean of the last hidden state over a clip's frames
    (zero for a clip too short to give one).

Inside `encode` the clips are packed: the hidden state is [R, hidden], R
the clips' frames summed, clip after clip, and Clips says where each clip's
rows lie (its offsets [B + 1] on the device).  No padded frame goes
through a layer: every row-wise product, the attention (which reads each
clip's rows from its offset) and the conv module (whose causal conv stops
at each clip's first row) run on the clips' own frames alone.  So a clip's
embedding is the same alone and inside a batch: its fbank rows read only
its samples and its own frames' statistics, and nothing of another clip
reaches its rows.

Weights live in a dict under the checkpoint's parameter names
(param_shapes; `masked_spec_embed`, used only in pre-training, is not
kept), so a checkpoint saved by persist.save_wavlm loads by name.
Without one they are drawn from the config's seed on the first device that
runs the encoder, at the published initial scales (init_params); each
other device gets a copy (parallel.mesh.replicate).

Traced (utils.profiling), an `encode` call is the span `w2v_bert.encode`,
holding `w2v_bert.fbank` and, a layer, one `w2v_bert.attention` and one
`w2v_bert.conv_module`, and counts `w2v_bert.batches`, `valid_frames`,
`sent_frames` (the rows the layers ran on: R, the valid frames, since the
rows are packed), `attn_pairs_valid` (sum of T_i^2), `attn_pairs_sent`
(the pairs of the rows handed to the attention: sum of T_i^2 too) and
`attn_pairs_run` (the pairs the attention kernel multiplies:
attn_pairs_run).
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple

import numpy as np
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
CONV_TAPS = 31  # the depthwise conv's taps the kernel takes (the published model's)
CONV_CHANNELS = 32  # the kernel's channels a block: the width must be a multiple


class Clips(NamedTuple):
    """Where each clip's rows lie in a packed [R, ...] tensor, clip after
    clip: clip b's rows are offsets[b] .. offsets[b + 1] - 1."""

    offsets: torch.Tensor  # int32 [B + 1] on the rows' device
    frames: torch.Tensor  # int64 [B] on the host: each clip's rows

    @property
    def longest(self) -> int:
        return int(self.frames.max()) if len(self.frames) else 0


# The packing's index and offsets are built with numpy on the host: the
# card waits for them, and PyTorch's CPU ops on these few dozen values took
# up to milliseconds each on an H100 machine's host, numpy's microseconds.

def _offsets(frames: np.ndarray) -> np.ndarray:
    out = np.zeros(len(frames) + 1, np.int32)
    out[1:] = np.cumsum(frames)
    return out


def _pack_index(frames: np.ndarray, T: int) -> np.ndarray:
    b = np.repeat(np.arange(len(frames)), frames)
    return b * T + np.arange(len(b)) - (np.cumsum(frames) - frames)[b]


def pack_clips(frames, device) -> Clips:
    """The Clips of clips of `frames` rows each (ints or an integer
    tensor on the host), their offsets on `device`."""
    frames = np.asarray(frames, np.int64).reshape(-1)
    return Clips(torch.from_numpy(_offsets(frames)).to(device), torch.from_numpy(frames))


def pack_index(frames, T: int) -> torch.Tensor:
    """[R] int64 on the host: the position in a [B, T] layout of each
    clip's rows t < frames[b], clip after clip."""
    return torch.from_numpy(_pack_index(np.asarray(frames, np.int64).reshape(-1), T))


def row_starts(clips: Clips, device) -> torch.Tensor:
    """[R] int64 on `device`: the first row of each row's clip."""
    f = clips.frames.numpy()
    return torch.from_numpy(np.repeat(np.cumsum(f) - f, f)).to(device)


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


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, clips: Clips) -> torch.Tensor:
    """x [R, C] packed rows -> the causal depthwise conv [R, C] with w
    [C, 1, K]: row r of a clip whose first row is s reads rows
    max(s, r - K + 1) .. r, the rows before s counting as zero."""
    R, K = x.shape[0], w.shape[-1]
    start = row_starts(clips, x.device)
    r = torch.arange(R, device=x.device)
    taps = w[:, 0, :]
    y = x * taps[:, K - 1]
    for d in range(1, min(K, R)):
        own = (r[d:] - d >= start[d:])[:, None]
        y[d:] += torch.where(own, x[:-d], 0.0) * taps[:, K - 1 - d]
    return y


def glu_depthwise_plain(x: torch.Tensor, w: torch.Tensor, clips: Clips) -> torch.Tensor:
    """x [R, 2 C] packed rows -> depthwise_conv(GLU(x)) [R, C], in
    PyTorch."""
    return depthwise_conv(F.glu(x, dim=-1), w, clips)


def _glu_depthwise_cuda(x, w, clips, out=None):
    """The kernel's launch; `out`, if given, a float32 [>= R, C] buffer it
    writes its R rows into (the returned view)."""
    R, C = x.shape[0], x.shape[-1] // 2
    offsets = clips.offsets
    if (x.dim() != 2 or C % CONV_CHANNELS or tuple(w.shape) != (C, 1, CONV_TAPS)
            or any(t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous()
                   or t.data_ptr() % 16 for t in (x, w))
            or offsets.dtype != torch.int32 or offsets.shape != (len(clips.frames) + 1,)
            or offsets.device != x.device or R != int(clips.frames.sum())
            or out is not None and (out.dtype != torch.float32 or out.device != x.device
                                    or not out.is_contiguous() or out.dim() != 2
                                    or out.shape[0] < R or out.shape[1] != C)):
        raise ValueError(
            f"glu_depthwise kernel needs a contiguous float32 [R, 2 C] x (C a multiple of "
            f"{CONV_CHANNELS}, 16-byte aligned), a contiguous [C, 1, {CONV_TAPS}] weight on its "
            f"device and int32 offsets [B + 1] of R rows; got x {tuple(x.shape)} {x.dtype} "
            f"{x.stride()}, weight {tuple(w.shape)} {w.dtype}, offsets {offsets.dtype} "
            f"{tuple(offsets.shape)}, frames summed {int(clips.frames.sum())}")
    out = torch.empty(R, C, device=x.device) if out is None else out
    if R:
        fn = _build.bind("glu_depthwise", "glu_depthwise_launch", 4, 3)
        rc = _build.launch(fn, x, x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                           R, C, len(clips.frames))
        _build.check(rc, "glu_depthwise_launch")
        glu_depthwise.launches += 1
    return out[:R]


def glu_depthwise(x: torch.Tensor, w: torch.Tensor, clips: Clips) -> torch.Tensor:
    """The conv module's GLU and causal depthwise conv: x [R, 2 C] packed
    rows (the first pointwise conv's output), w [C, 1, K] -> [R, C].  A
    CUDA tensor launches csrc/glu_depthwise.cu (K = 31 taps); a CPU tensor
    runs glu_depthwise_plain."""
    if x.is_cuda:
        return _glu_depthwise_cuda(x, w, clips)
    if x.device.type == "cpu":
        return glu_depthwise_plain(x, w, clips)
    raise ValueError(f"glu_depthwise: no kernel for device {x.device}")


glu_depthwise.launches = 0  # kernel launches


def conv_module(p: dict, i: int, h: torch.Tensor, clips: Clips,
                cfg: W2VBertConfig) -> torch.Tensor:
    """Layer i's convolution module on the packed rows h [R, D], channels
    last: LN, the pointwise conv to 2 D, glu_depthwise (GLU, the causal
    depthwise conv within each clip), LN, swish, the pointwise conv to D."""
    pre = LAYER.format(i) + "conv_module."
    x = F.linear(_ln(p, pre + "layer_norm", h, cfg), p[pre + "pointwise_conv1.weight"][..., 0])
    x = glu_depthwise(x, p[pre + "depthwise_conv.weight"], clips)
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
                           clips: Clips, cfg: W2VBertConfig) -> torch.Tensor:
    """Layer i's attention core in PyTorch: each head's slice of the packed
    q, k, v [R, D] laid out [B, T] (T the longest clip), the relative-key
    term and the key mask of each clip's frames built whole, softmax(q k^T
    / sqrt(head_dim) + that) v, packed back -> [R, D]."""
    R, D = q.shape
    B, T = len(clips.frames), clips.longest
    if R == 0:
        return q.new_zeros(0, D)
    heads = cfg.num_attention_heads
    idx = pack_index(clips.frames, T).to(q.device)

    def split(y):
        y = y.new_zeros(B * T, D).index_copy_(0, idx, y)
        return y.view(B, T, heads, D // heads).transpose(1, 2)

    dist_idx = distance_index(T, cfg.left_max_position_embeddings,
                              cfg.right_max_position_embeddings, q.device)
    qh = split(q)
    bias = rel_key_scores(qh, p[LAYER.format(i) + "self_attn.distance_embedding.weight"], dist_idx)
    # a clip of no frame has no row, but its padded rows' softmax must not
    # be empty: their first key stays unmasked
    mask = wavlm.key_mask(_valid(clips.frames.to(q.device), T)
                          | (torch.arange(T, device=q.device) == 0))
    a = F.scaled_dot_product_attention(qh, split(k), split(v), attn_mask=bias + mask)
    return a.transpose(1, 2).reshape(B * T, D).index_select(0, idx)


def _relkey_attention_cuda(p, i, q, k, v, clips, cfg, pairs=None):
    """The kernel's launch; `pairs`, a CUDA int64 [1] tensor, gets the
    query-key pairs the kernel multiplied added to it."""
    R, D = q.shape[0], q.shape[-1]
    heads = cfg.num_attention_heads
    left, right = cfg.left_max_position_embeddings, cfg.right_max_position_embeddings
    dist = p[LAYER.format(i) + "self_attn.distance_embedding.weight"]
    offsets = clips.offsets
    acts = (q, k, v)
    if (q.dim() != 2 or D != heads * ATTN_HEAD_DIM or left < 0 or right < 0
            or left + right + 1 > NREL_MAX
            or tuple(dist.shape) != (left + right + 1, ATTN_HEAD_DIM)
            or any(t.shape != q.shape or t.stride(1) != 1 or t.stride(0) % 4 or t.data_ptr() % 16
                   for t in acts)
            or any(t.dtype != torch.float32 or t.device != q.device for t in (*acts, dist))
            or not dist.is_contiguous() or dist.data_ptr() % 16
            or offsets.dtype != torch.int32 or offsets.shape != (len(clips.frames) + 1,)
            or offsets.device != q.device or R != int(clips.frames.sum())
            or pairs is not None and (pairs.dtype != torch.int64 or pairs.device != q.device)):
        raise ValueError(
            f"relkey_attention kernel needs float32 packed [R, heads x {ATTN_HEAD_DIM}] q, k, v "
            f"on one device (last stride 1, 16-byte rows), a contiguous distance_embedding of "
            f"at most {NREL_MAX} rows of {ATTN_HEAD_DIM} and int32 offsets [B + 1] of R rows; got "
            f"{tuple(q.shape)} {[(t.dtype, t.stride()) for t in acts]}, distance_embedding "
            f"{tuple(dist.shape)}, offsets {offsets.dtype} {tuple(offsets.shape)}, frames "
            f"summed {int(clips.frames.sum())}")
    out = torch.empty(R, D, device=q.device)
    if R == 0:
        return out
    fn = _build.bind("gated_attention", "relkey_attention_launch", 7, 8)
    ptrs = [t.data_ptr() for t in (*acts, dist, offsets, out)]
    ptrs.append(None if pairs is None else pairs.data_ptr())
    rc = _build.launch(fn, q, *ptrs, len(clips.frames), clips.longest, heads, left, right,
                       *(t.stride(0) for t in acts))
    _build.check(rc, "relkey_attention_launch")
    _LAUNCHES.launches += 1
    return out


def relkey_attention(p: dict, i: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     clips: Clips, cfg: W2VBertConfig) -> torch.Tensor:
    """Layer i's attention core over packed rows: the projections q, k, v
    [R, D], `clips` where each clip's rows lie -> softmax((q k^T + q
    D[clamp(j - i)]^T) / sqrt(head_dim)) v [R, D], each clip's rows over its
    own keys.  A CUDA tensor launches the relative-key mode of
    csrc/gated_attention.cu; a CPU tensor runs relkey_attention_plain."""
    if q.is_cuda:
        return _relkey_attention_cuda(p, i, q, k, v, clips, cfg)
    if q.device.type == "cpu":
        return relkey_attention_plain(p, i, q, k, v, clips, cfg)
    raise ValueError(f"relkey_attention: no kernel for device {q.device}")


relkey_attention.launches = 0  # kernel launches
# the function that holds the count: a caller may wrap the module's name
# (a tracing span), and the count stays on the function itself
_LAUNCHES = relkey_attention


def conformer_layer(p: dict, i: int, h: torch.Tensor, clips: Clips,
                    cfg: W2VBertConfig) -> torch.Tensor:
    """One Conformer layer on the packed rows h [R, D]: the half-step FFN1,
    the relative-key attention, the convolution module, the half-step
    FFN2, each residual, then the final LayerNorm."""
    pre = LAYER.format(i)
    h = h + 0.5 * feed_forward(p, pre + "ffn1", _ln(p, pre + "ffn1_layer_norm", h, cfg))
    x = _ln(p, pre + "self_attn_layer_norm", h, cfg)
    q, k, v = (F.linear(x, p[f"{pre}self_attn.{name}.weight"], p[f"{pre}self_attn.{name}.bias"])
               for name in ("linear_q", "linear_k", "linear_v"))
    with span("w2v_bert.attention"):
        a = relkey_attention(p, i, q, k, v, clips, cfg)
    h = h + F.linear(a, p[pre + "self_attn.linear_out.weight"], p[pre + "self_attn.linear_out.bias"])
    with span("w2v_bert.conv_module"):
        h = h + conv_module(p, i, h, clips, cfg)
    h = h + 0.5 * feed_forward(p, pre + "ffn2", _ln(p, pre + "ffn2_layer_norm", h, cfg))
    return _ln(p, pre + "final_layer_norm", h, cfg)


def attn_pairs_run(frames) -> int:
    """Query-key pairs a head the attention kernel multiplies for clips of
    these frame counts: wavlm.attn_pairs_run over the clips that have a
    frame (a clip of none has no row, and its blocks return at once)."""
    return wavlm.attn_pairs_run([t for t in torch.as_tensor(frames).tolist() if t > 0])


def _count(frames: list) -> None:
    """The counters of one encode call, in plain Python (PyTorch's CPU ops
    would keep the card waiting)."""
    pairs = sum(t * t for t in frames)
    count("w2v_bert.batches", 1)
    count("w2v_bert.valid_frames", sum(frames))
    # packed: the layers run on the clips' own rows, the attention on each
    # clip's own pairs
    count("w2v_bert.sent_frames", sum(frames))
    count("w2v_bert.attn_pairs_valid", pairs)
    count("w2v_bert.attn_pairs_sent", pairs)
    count("w2v_bert.attn_pairs_run", attn_pairs_run(frames))


def encode(p: dict, audio: torch.Tensor, lengths: torch.Tensor,
           cfg: W2VBertConfig) -> torch.Tensor:
    """audio [B, N] (zero-padded), lengths [B] samples -> the embeddings
    [B, hidden_size]: the mean of the last hidden state over each clip's
    frames (zero for a clip too short to give one).  The fbank runs on the
    padded batch; its rows past each clip's frames are dropped, and the
    layers run on the clips' frames packed."""
    B, N = audio.shape
    T = frame_lengths(N)
    if T <= 0:
        return audio.new_zeros(B, cfg.hidden_size)
    # each clip's rows, read back before any launch; the offsets and the
    # packing's index go up as one int32 buffer while the card has nothing
    # of this call queued
    frames = frame_lengths(lengths.cpu().long()).clamp(max=T).numpy()
    up = torch.from_numpy(np.concatenate([_offsets(frames), _pack_index(frames, T).astype(np.int32)]))
    up = up.to(audio.device)
    clips = Clips(up[: B + 1], torch.from_numpy(frames))
    idx = up[B + 1 :]
    with span("w2v_bert.encode"):
        with span("w2v_bert.fbank"):
            feats, _ = fbank.features(audio, lengths.to(audio.device).long())
        if tracing():
            _count(frames.tolist())
        if not len(idx):
            return audio.new_zeros(B, cfg.hidden_size)
        h = project(p, feats.reshape(B * T, -1).index_select(0, idx), cfg)
        for i in range(cfg.num_hidden_layers):
            h = conformer_layer(p, i, h, clips, cfg)
        # each clip's rows summed in order; a clip of no row sums to zero
        summed = torch.segment_reduce(h, "sum", offsets=clips.offsets, axis=0, unsafe=True)
        return summed / clips.offsets.diff().clamp(min=1).to(h.dtype)[:, None]


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
