"""A plain reference of the W2V-BERT 2.0 clip embedding: float32 PyTorch, one
clip at a time and unpadded, no kernel of any package, written from
transformers' feature_extraction_seamless_m4t.py (SeamlessM4TFeatureExtractor
at its defaults, through audio_utils.spectrogram and mel_filter_bank) and
modeling_wav2vec2_bert.py (Wav2Vec2BertModel with position_embeddings_type
"relative_key", no adapter, no intermediate FFN).  It imports nothing but
torch.

Two byte-identical copies exist: tests/ref_w2v_bert.py and
benchmark/reference/w2v_bert.py.

`params` maps the checkpoint's parameter names to tensors; `cfg` maps the
names of facebook/w2v-bert-2.0's config.json (hidden_size,
num_hidden_layers, num_attention_heads, intermediate_size,
feature_projection_input_dim, conv_depthwise_kernel_size,
left_max_position_embeddings, right_max_position_embeddings,
layer_norm_eps) to their values.  draw_params draws a check's weights
under those names.  embed runs with TF32 off for matmuls and cuDNN unless
asked for it (the control's precision below the configuration's).

Where it departs from the two transformers files:
  * the fbank in float32 torch on the weights' device, where the extractor
    frames, transforms and filters in float64 numpy (keeping the spectrum
    as complex64) and casts the log-mel to float32;
  * the extractor pads a clip of an odd number of frames with a zero frame
    and masks the pair that holds it; here the odd last frame is dropped
    (the same rows reach the model);
  * inference only: no dropout, LayerDrop or SpecAugment masking, so
    masked_spec_embed is not used;
  * one clip with no padding, so there is no attention_mask: the zeroing of
    padded frames, the key-padding mask and the conv module's masked_fill
    have nothing to act on;
  * the attention is written out per head; the relative-key term is q_i .
    D[clamp(j - i, -left, right) + left] summed over the head dims, as
    transformers' einsum "bhld,lrd->bhlr" computes it;
  * added around the model, in neither file: the embedding, the mean of
    the last hidden state over the clip's frames.
"""

import math

import torch
import torch.nn.functional as F

SR = 16000
WIN, HOP, NFFT, MELS = 400, 160, 512, 80


def n_frames(n: int) -> int:
    """The encoder's frames for n samples: fbank frames, then pairs."""
    return (1 + (n - WIN) // HOP) // 2 if n >= WIN else 0


def mel_bank() -> torch.Tensor:
    """[257, 80]: triangles in Kaldi mel space (1127 ln(1 + f / 700)),
    80 of them between 20 and 8000 Hz, over the bins' mel frequencies."""
    def mel(f):
        return 1127.0 * torch.log(1.0 + f / 700.0)

    lo, hi = mel(torch.tensor(20.0, dtype=torch.float64)), mel(torch.tensor(8000.0, dtype=torch.float64))
    centres = torch.linspace(float(lo), float(hi), MELS + 2, dtype=torch.float64)
    bins = mel(torch.arange(NFFT // 2 + 1, dtype=torch.float64) * (SR / NFFT))
    out = torch.zeros(NFFT // 2 + 1, MELS, dtype=torch.float64)
    for m in range(MELS):
        left, mid, right = centres[m], centres[m + 1], centres[m + 2]
        rise = (bins - left) / (mid - left)
        fall = (right - bins) / (right - mid)
        out[:, m] = torch.clamp(torch.minimum(rise, fall), min=0.0)
    return out.float()


def fbank(y: torch.Tensor) -> torch.Tensor:
    """One clip y [n] -> SeamlessM4TFeatureExtractor's input_features
    [n_frames(n), 160]."""
    x = y.float() * 32768.0
    count = 1 + (x.shape[0] - WIN) // HOP
    idx = torch.arange(count, device=x.device)[:, None] * HOP + torch.arange(WIN, device=x.device)
    frames = x[idx]
    frames = frames - frames.mean(dim=1, keepdim=True)
    emph = torch.empty_like(frames)
    emph[:, 1:] = frames[:, 1:] - 0.97 * frames[:, :-1]
    emph[:, 0] = frames[:, 0] * (1.0 - 0.97)
    n = torch.arange(WIN, dtype=torch.float64)
    window = torch.pow(0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (WIN - 1)), 0.85)
    buf = torch.zeros(count, NFFT, device=x.device)
    buf[:, :WIN] = emph * window.float().to(x.device)
    spec = torch.fft.rfft(buf, dim=1)
    power = spec.real ** 2 + spec.imag ** 2
    logmel = torch.log(torch.clamp(power @ mel_bank().to(x.device), min=1.192092955078125e-07))
    mean = logmel.mean(dim=0, keepdim=True)
    var = logmel.var(dim=0, unbiased=True, keepdim=True)
    feats = (logmel - mean) / torch.sqrt(var + 1e-7)
    pairs = count // 2
    return feats[: 2 * pairs].reshape(pairs, 2 * MELS)


def param_shapes(cfg: dict) -> dict:
    """The checkpoint's parameter names and shapes, in the order
    draw_params draws them (masked_spec_embed, used only in pre-training,
    left out)."""
    D, Fd = cfg["hidden_size"], cfg["intermediate_size"]
    C, K = cfg["feature_projection_input_dim"], cfg["conv_depthwise_kernel_size"]
    dh = D // cfg["num_attention_heads"]
    rel = cfg["left_max_position_embeddings"] + cfg["right_max_position_embeddings"] + 1
    shapes = {"feature_projection.layer_norm.weight": (C,),
              "feature_projection.layer_norm.bias": (C,),
              "feature_projection.projection.weight": (D, C),
              "feature_projection.projection.bias": (D,)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}."
        for part in ("ffn1", "self_attn", "conv_module", "ffn2", "final"):
            if part in ("ffn1", "ffn2"):
                shapes[f"{pre}{part}_layer_norm.weight"] = (D,)
                shapes[f"{pre}{part}_layer_norm.bias"] = (D,)
                shapes[f"{pre}{part}.intermediate_dense.weight"] = (Fd, D)
                shapes[f"{pre}{part}.intermediate_dense.bias"] = (Fd,)
                shapes[f"{pre}{part}.output_dense.weight"] = (D, Fd)
                shapes[f"{pre}{part}.output_dense.bias"] = (D,)
            elif part == "self_attn":
                shapes[pre + "self_attn_layer_norm.weight"] = (D,)
                shapes[pre + "self_attn_layer_norm.bias"] = (D,)
                for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
                    shapes[f"{pre}self_attn.{proj}.weight"] = (D, D)
                    shapes[f"{pre}self_attn.{proj}.bias"] = (D,)
                shapes[pre + "self_attn.distance_embedding.weight"] = (rel, dh)
            elif part == "conv_module":
                m = pre + "conv_module."
                shapes[m + "layer_norm.weight"] = (D,)
                shapes[m + "layer_norm.bias"] = (D,)
                shapes[m + "pointwise_conv1.weight"] = (2 * D, D, 1)
                shapes[m + "depthwise_conv.weight"] = (D, 1, K)
                shapes[m + "depthwise_layer_norm.weight"] = (D,)
                shapes[m + "depthwise_layer_norm.bias"] = (D,)
                shapes[m + "pointwise_conv2.weight"] = (D, D, 1)
            else:
                shapes[pre + "final_layer_norm.weight"] = (D,)
                shapes[pre + "final_layer_norm.bias"] = (D,)
    return shapes


def draw_params(cfg: dict, seed: int, device="cpu") -> dict:
    """Weights for a check, drawn name by name on `device` from a generator
    seeded with `seed`, none of them at a value that would hide a port
    leaving it out.  The matrices at the published initial scales: the
    projection uniform in +-sqrt(1 / fan_in) (its bias too), the three
    convs Kaiming-normal (std sqrt(2 / fan_in)), distance_embedding
    standard normal, every other matrix normal with std 0.02.  In place of
    the published constants: every other bias N(0, 0.02), each
    LayerNorm's weight 1 + N(0, 0.1) and bias N(0, 0.1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def normal(shape, std, mean=0.0):
        return torch.randn(shape, generator=gen, device=device) * std + mean

    out = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("feature_projection.projection"):
            bound = math.sqrt(1.0 / cfg["feature_projection_input_dim"])
            out[name] = (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound
        elif "layer_norm" in name:
            out[name] = normal(shape, 0.1, 1.0 if leaf == "weight" else 0.0)
        elif len(shape) == 3:
            out[name] = normal(shape, math.sqrt(2.0 / (shape[1] * shape[2])))
        elif name.endswith("distance_embedding.weight"):
            out[name] = normal(shape, 1.0)
        else:
            out[name] = normal(shape, 0.02)
    return out


def hidden_states(params: dict, feats: torch.Tensor, cfg: dict) -> torch.Tensor:
    """One clip's input_features [T, 160] (on the weights' device) -> the
    last hidden state [T, hidden_size]."""
    P = params
    eps = cfg["layer_norm_eps"]

    def ln(name, x):
        return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], eps)

    def lin(name, x):
        return x @ P[name + ".weight"].T + P[name + ".bias"]

    def ffn(name, x):
        h = lin(name + ".intermediate_dense", x)
        return lin(name + ".output_dense", h * torch.sigmoid(h))

    h = lin("feature_projection.projection", ln("feature_projection.layer_norm", feats))
    T, D = h.shape
    H = cfg["num_attention_heads"]
    dh = D // H
    left, right = cfg["left_max_position_embeddings"], cfg["right_max_position_embeddings"]
    pos = torch.arange(T, device=h.device)
    distance = torch.clamp(pos[None, :] - pos[:, None], -left, right) + left  # [T, T]
    K = cfg["conv_depthwise_kernel_size"]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}."
        h = h + 0.5 * ffn(pre + "ffn1", ln(pre + "ffn1_layer_norm", h))

        a = pre + "self_attn."
        x = ln(pre + "self_attn_layer_norm", h)
        q = lin(a + "linear_q", x).view(T, H, dh).transpose(0, 1)
        k = lin(a + "linear_k", x).view(T, H, dh).transpose(0, 1)
        v = lin(a + "linear_v", x).view(T, H, dh).transpose(0, 1)
        scores = q @ k.transpose(1, 2) / math.sqrt(dh)
        emb = P[a + "distance_embedding.weight"][distance]  # [T, T, dh]
        scores = scores + torch.einsum("hld,lrd->hlr", q, emb) / math.sqrt(dh)
        ctx = torch.softmax(scores, dim=-1) @ v  # [H, T, dh]
        h = h + lin(a + "linear_out", ctx.transpose(0, 1).reshape(T, D))

        m = pre + "conv_module."
        c = ln(m + "layer_norm", h).T[None]  # [1, D, T]
        c = F.conv1d(c, P[m + "pointwise_conv1.weight"])
        c = F.glu(c, dim=1)
        c = F.conv1d(F.pad(c, (K - 1, 0)), P[m + "depthwise_conv.weight"], groups=D)
        c = ln(m + "depthwise_layer_norm", c[0].T)
        c = c * torch.sigmoid(c)
        c = F.conv1d(c.T[None], P[m + "pointwise_conv2.weight"])[0].T
        h = h + c

        h = h + 0.5 * ffn(pre + "ffn2", ln(pre + "ffn2_layer_norm", h))
        h = ln(pre + "final_layer_norm", h)
    return h


def embed(params: dict, y, cfg: dict, tf32: bool = False) -> torch.Tensor:
    """One clip (array or tensor of samples, at least 800 of them) -> its
    embedding [hidden_size]: the fbank, the encoder, the mean of the last
    hidden state over its frames; matmuls and cuDNN in TF32 only if
    `tf32`."""
    dev = params["feature_projection.projection.weight"].device
    y = torch.as_tensor(y, dtype=torch.float32).to(dev)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            return hidden_states(params, fbank(y), cfg).mean(0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
