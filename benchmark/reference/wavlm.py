"""A plain reference of the WavLM clip embedding: float32 PyTorch, one clip
at a time and unpadded, no kernel of any package, written from the
stable-layer-norm model of transformers' modeling_wavlm.py
(WavLMModel with feat_extract_norm "layer", conv_bias false,
do_stable_layer_norm true).  It imports nothing but torch.

Two byte-identical copies exist: tests/ref_wavlm.py and
benchmark/reference/wavlm.py.

`params` maps the checkpoint's parameter names to tensors; `cfg` maps the
names of microsoft/wavlm-large's config.json (conv_dim, conv_kernel,
conv_stride, hidden_size, num_hidden_layers, num_attention_heads,
intermediate_size, num_conv_pos_embeddings, num_conv_pos_embedding_groups,
num_buckets, max_bucket_distance, layer_norm_eps) to their values.
draw_params draws a check's weights under those names.

Where it departs from modeling_wavlm.py:
  * inference only: no dropout, LayerDrop or SpecAugment masking, so
    masked_spec_embed is not used;
  * one clip with no padding, so there is no attention_mask: the zeroing of
    padded frames and the key-padding mask have nothing to act on;
  * the positional conv's weight norm is written out, g v / |v| with the
    norm over dims 0 and 1, in place of the weight_norm parametrization;
  * the attention is written out per head, softmax(q k^T / sqrt(head_dim)
    + gated bias) v, in place of F.multi_head_attention_forward;
  * the bucket of a zero distance takes log(1) where modeling_wavlm.py
    takes log(0); the exact branch is chosen there either way;
  * added around the model, neither in modeling_wavlm.py: the input
    normalisation (zero mean, unit population variance, eps 1e-7, as
    Wav2Vec2FeatureExtractor's do_normalize) and the embedding, the mean of
    the last hidden state over the clip's frames.
"""

import math

import torch
import torch.nn.functional as F

INPUT_EPS = 1e-7
CONV_LN_EPS = 1e-5


def n_frames(n: int, cfg: dict) -> int:
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
    return n


def buckets(T: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """_relative_positions_bucket of (key - query) for a T-frame clip."""
    ctx = torch.arange(T, dtype=torch.long)[:, None]
    mem = torch.arange(T, dtype=torch.long)[None, :]
    rel = mem - ctx
    half = num_buckets // 2
    out = (rel > 0).to(torch.long) * half
    rel = torch.abs(rel)
    max_exact = half // 2
    is_small = rel < max_exact
    large = torch.log(torch.clamp(rel, min=1).float() / max_exact)
    large = large / math.log(max_distance / max_exact)
    large = large * (half - max_exact)
    large = (max_exact + large).to(torch.long)
    large = torch.min(large, torch.full_like(large, half - 1))
    return out + torch.where(is_small, rel, large)


def param_shapes(cfg: dict) -> dict:
    """The checkpoint's parameter names and shapes, in the order
    draw_params draws them (masked_spec_embed, used only in pre-training,
    left out)."""
    shapes = {}
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        pre = f"feature_extractor.conv_layers.{i}."
        shapes[pre + "conv.weight"] = (c, c_in, k)
        shapes[pre + "layer_norm.weight"] = (c,)
        shapes[pre + "layer_norm.bias"] = (c,)
        c_in = c
    D, H, Fd = cfg["hidden_size"], cfg["num_attention_heads"], cfg["intermediate_size"]
    k = cfg["num_conv_pos_embeddings"]
    shapes["feature_projection.layer_norm.weight"] = (c_in,)
    shapes["feature_projection.layer_norm.bias"] = (c_in,)
    shapes["feature_projection.projection.weight"] = (D, c_in)
    shapes["feature_projection.projection.bias"] = (D,)
    shapes["encoder.pos_conv_embed.conv.weight_g"] = (1, 1, k)
    shapes["encoder.pos_conv_embed.conv.weight_v"] = (D, D // cfg["num_conv_pos_embedding_groups"], k)
    shapes["encoder.pos_conv_embed.conv.bias"] = (D,)
    shapes["encoder.layer_norm.weight"] = (D,)
    shapes["encoder.layer_norm.bias"] = (D,)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{pre}attention.{proj}.weight"] = (D, D)
            shapes[f"{pre}attention.{proj}.bias"] = (D,)
        shapes[pre + "attention.gru_rel_pos_const"] = (1, H, 1, 1)
        shapes[pre + "attention.gru_rel_pos_linear.weight"] = (8, D // H)
        shapes[pre + "attention.gru_rel_pos_linear.bias"] = (8,)
        if i == 0:
            shapes[pre + "attention.rel_attn_embed.weight"] = (cfg["num_buckets"], H)
        for ln in ("layer_norm", "final_layer_norm"):
            shapes[f"{pre}{ln}.weight"] = (D,)
            shapes[f"{pre}{ln}.bias"] = (D,)
        shapes[pre + "feed_forward.intermediate_dense.weight"] = (Fd, D)
        shapes[pre + "feed_forward.intermediate_dense.bias"] = (Fd,)
        shapes[pre + "feed_forward.output_dense.weight"] = (D, Fd)
        shapes[pre + "feed_forward.output_dense.bias"] = (D,)
    return shapes


def draw_params(cfg: dict, seed: int, device="cpu") -> dict:
    """Weights for a check, drawn name by name on `device` from a generator
    seeded with `seed`, none of them at a value that would hide a port
    leaving it out.  The matrices at the published initial scales: the
    feature convs Kaiming-normal, the projection uniform in
    +-sqrt(1 / fan_in) (its bias too), the positional conv's v normal with
    std 2 sqrt(1 / (taps x hidden)), rel_attn_embed standard normal, every
    other matrix normal with std 0.02.  In place of the published
    constants: every other bias N(0, 0.02), each LayerNorm's weight
    1 + N(0, 0.1) and bias N(0, 0.1), gru_rel_pos_const U(0.5, 1.5) per
    head, and the weight norm's g = |v| U(0.5, 1.5) per tap."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def normal(shape, std, mean=0.0):
        return torch.randn(shape, generator=gen, device=device) * std + mean

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    out = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("feature_extractor") and leaf == "weight" and len(shape) == 3:
            out[name] = normal(shape, math.sqrt(2.0 / (shape[1] * shape[2])))
        elif name.startswith("feature_projection.projection"):
            bound = math.sqrt(1.0 / cfg["conv_dim"][-1])
            out[name] = uniform(shape, -bound, bound)
        elif leaf == "weight_g":
            continue  # drawn after v
        elif leaf == "weight_v":
            out[name] = normal(shape, 2.0 * math.sqrt(1.0 / (shape[2] * cfg["hidden_size"])))
            norm = torch.sqrt((out[name] ** 2).sum(dim=(0, 1), keepdim=True))
            out["encoder.pos_conv_embed.conv.weight_g"] = norm * uniform(norm.shape, 0.5, 1.5)
        elif "layer_norm" in name:
            out[name] = normal(shape, 0.1, 1.0 if leaf == "weight" else 0.0)
        elif leaf == "gru_rel_pos_const":
            out[name] = uniform(shape, 0.5, 1.5)
        elif name.endswith("rel_attn_embed.weight"):
            out[name] = normal(shape, 1.0)
        else:
            out[name] = normal(shape, 0.02)
    return {name: out[name] for name in param_shapes(cfg)}


def hidden_states(params: dict, y: torch.Tensor, cfg: dict) -> torch.Tensor:
    """One clip y [n] (float32, on the weights' device) -> the last hidden
    state [T, hidden_size]."""
    P = params
    x = (y - y.mean()) / torch.sqrt(y.var(unbiased=False) + INPUT_EPS)
    h = x[None, None, :]
    for i, s in enumerate(cfg["conv_stride"]):
        pre = f"feature_extractor.conv_layers.{i}."
        h = F.conv1d(h, P[pre + "conv.weight"], stride=s)
        h = h.transpose(-2, -1)
        h = F.layer_norm(h, (h.shape[-1],), P[pre + "layer_norm.weight"],
                         P[pre + "layer_norm.bias"], CONV_LN_EPS)
        h = F.gelu(h.transpose(-2, -1))
    h = h[0].transpose(0, 1)  # [T, C]
    eps = cfg["layer_norm_eps"]
    h = F.layer_norm(h, (h.shape[-1],), P["feature_projection.layer_norm.weight"],
                     P["feature_projection.layer_norm.bias"], eps)
    h = h @ P["feature_projection.projection.weight"].T + P["feature_projection.projection.bias"]

    g = P["encoder.pos_conv_embed.conv.weight_g"]
    v = P["encoder.pos_conv_embed.conv.weight_v"]
    w = g * v / torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
    k = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(h.T[None], w, P["encoder.pos_conv_embed.conv.bias"], padding=k // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + F.gelu(pos)[0].T

    T, D = h.shape
    H = cfg["num_attention_heads"]
    dh = D // H
    table = buckets(T, cfg["num_buckets"], cfg["max_bucket_distance"]).to(h.device)
    bias = P["encoder.layers.0.attention.rel_attn_embed.weight"][table].permute(2, 0, 1)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}."
        a = pre + "attention."
        res = h
        x = F.layer_norm(h, (D,), P[pre + "layer_norm.weight"], P[pre + "layer_norm.bias"], eps)
        gp = x.view(T, H, dh).permute(1, 0, 2) @ P[a + "gru_rel_pos_linear.weight"].T
        gp = (gp + P[a + "gru_rel_pos_linear.bias"]).view(H, T, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(gp).chunk(2, dim=-1)
        gate = gate_a * (gate_b * P[a + "gru_rel_pos_const"][0] - 1.0) + 2.0  # [H, T, 1]
        q = (x @ P[a + "q_proj.weight"].T + P[a + "q_proj.bias"]).view(T, H, dh).transpose(0, 1)
        kk = (x @ P[a + "k_proj.weight"].T + P[a + "k_proj.bias"]).view(T, H, dh).transpose(0, 1)
        vv = (x @ P[a + "v_proj.weight"].T + P[a + "v_proj.bias"]).view(T, H, dh).transpose(0, 1)
        scores = (q * dh ** -0.5) @ kk.transpose(1, 2) + gate * bias
        ctx = torch.softmax(scores, dim=-1) @ vv  # [H, T, dh]
        out = ctx.transpose(0, 1).reshape(T, D) @ P[a + "out_proj.weight"].T + P[a + "out_proj.bias"]
        h = res + out
        f = F.layer_norm(h, (D,), P[pre + "final_layer_norm.weight"],
                         P[pre + "final_layer_norm.bias"], eps)
        f = F.gelu(f @ P[pre + "feed_forward.intermediate_dense.weight"].T
                   + P[pre + "feed_forward.intermediate_dense.bias"])
        h = h + (f @ P[pre + "feed_forward.output_dense.weight"].T
                 + P[pre + "feed_forward.output_dense.bias"])
    return F.layer_norm(h, (D,), P["encoder.layer_norm.weight"], P["encoder.layer_norm.bias"], eps)


def embed(params: dict, y, cfg: dict) -> torch.Tensor:
    """One clip (array or tensor of samples) -> its embedding [hidden_size]:
    the mean of the last hidden state over its frames."""
    dev = params["encoder.layer_norm.weight"].device
    y = torch.as_tensor(y, dtype=torch.float32).to(dev)
    with torch.no_grad():
        return hidden_states(params, y, cfg).mean(0)


def mlp_proba(weights: list, biases: list, x: torch.Tensor) -> torch.Tensor:
    """x [d_in] through S seeded ReLU MLPs (weights [S, d_in, d_out], biases
    [S, d_out] per layer) -> the mean over seeds of their softmax."""
    h = x[None, :].expand(weights[0].shape[0], -1)
    for j, (w, b) in enumerate(zip(weights, biases)):
        h = torch.einsum("si,sio->so", h, w) + b
        if j < len(weights) - 1:
            h = torch.relu(h)
    return torch.softmax(h, dim=-1).mean(0)
