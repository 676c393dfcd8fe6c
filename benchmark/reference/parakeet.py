"""A plain reference of the Parakeet-CTC-1.1B clip embedding: float32
PyTorch, one recording at a time and unpadded, no kernel of any package,
written from transformers' feature_extraction_parakeet.py
(ParakeetFeatureExtractor at its defaults) and modeling_parakeet.py
(ParakeetEncoder; the CTC head left out).  It imports nothing but torch.

Two byte-identical copies exist: tests/ref_parakeet.py and
benchmark/reference/parakeet.py.

`params` maps the checkpoint's parameter names (BatchNorm's running
statistics among them) to tensors; `cfg` maps the names of
nvidia/parakeet-ctc-1.1b's config.json (hidden_size, num_hidden_layers,
num_attention_heads, intermediate_size, conv_kernel_size,
subsampling_factor, subsampling_conv_channels,
subsampling_conv_kernel_size, subsampling_conv_stride, num_mel_bins,
scale_input) to their values.  draw_params draws a check's weights under
those names.  embed runs with TF32 off for matmuls and cuDNN unless asked
for it (the control's precision below the configuration's).

Where it departs from the two transformers files:
  * the slaney mel filters are built here from librosa's formula (the
    extractor calls librosa.filters.mel(norm="slaney"), not installed);
  * the power is |stft|^2 directly, where the extractor takes the
    magnitude's square root and squares it again;
  * inference only: no dropout or LayerDrop;
  * one recording with no padding: the encoder keeps the stem's first T
    frames, T = L // 160 halved three times ((T + 1) // 2 each), where
    transformers keeps the stem's whole output and masks the rows past T
    out of the attention and the conv module (they reach no kept row);
    the stem's time masks act as transformers' do, since the extractor's
    attention mask marks the last of its 1 + L // 160 frames as padding;
  * the attention is written out per head, with the rel-shift as
    transformers' _rel_shift computes it;
  * added around the model, in neither file: the embedding, the mean of
    the last hidden state over the recording's frames.
"""

import math

import torch
import torch.nn.functional as F

SR = 16000
HOP, NFFT, WIN = 160, 512, 400
PREEMPH = 0.97
LOG_GUARD = 2.0**-24
NORM_EPS = 1e-5
EPS = 1e-5  # LayerNorm's and BatchNorm's


def n_frames(n: int, cfg: dict | None = None) -> int:
    """The encoder's frames for n samples: n // 160 log-mel frames, then
    floor((T - 1) / 2) + 1 for each of the stem's strided convs."""
    t = n // HOP
    for _ in range(int(math.log2((cfg or {}).get("subsampling_factor", 8)))):
        t = (t - 1) // 2 + 1
    return t


def _hz_to_mel(f: torch.Tensor) -> torch.Tensor:
    """Slaney's mel scale: linear below 1 kHz, logarithmic above."""
    lin = f / (200.0 / 3)
    return torch.where(f >= 1000.0, 15.0 + torch.log(f / 1000.0) / (math.log(6.4) / 27.0), lin)


def _mel_to_hz(m: torch.Tensor) -> torch.Tensor:
    lin = m * (200.0 / 3)
    return torch.where(m >= 15.0, 1000.0 * torch.exp((math.log(6.4) / 27.0) * (m - 15.0)), lin)


def mel_bank(n_mels: int = 80) -> torch.Tensor:
    """[n_mels, 257]: librosa.filters.mel(sr=16000, n_fft=512, n_mels,
    fmin=0, fmax=8000, norm="slaney"), built in float64."""
    f64 = torch.float64
    freqs = torch.linspace(0.0, SR / 2, NFFT // 2 + 1, dtype=f64)
    hi = _hz_to_mel(torch.tensor(SR / 2, dtype=f64))
    edges = _mel_to_hz(torch.linspace(0.0, float(hi), n_mels + 2, dtype=f64))
    out = torch.zeros(n_mels, NFFT // 2 + 1, dtype=f64)
    for m in range(n_mels):
        rise = (freqs - edges[m]) / (edges[m + 1] - edges[m])
        fall = (edges[m + 2] - freqs) / (edges[m + 2] - edges[m + 1])
        out[m] = torch.clamp(torch.minimum(rise, fall), min=0.0) * 2.0 / (edges[m + 2] - edges[m])
    return out.float()


def fbank(y: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """One recording y [n] -> ParakeetFeatureExtractor's input_features
    [1 + n // 160, n_mels]: the first n // 160 frames normalised, the last
    zero."""
    x = y.float()
    x = torch.cat([x[:1], x[1:] - PREEMPH * x[:-1]])
    window = torch.hann_window(WIN, periodic=False, device=x.device)
    spec = torch.stft(x, NFFT, hop_length=HOP, win_length=WIN, window=window,
                      return_complex=True, pad_mode="constant")
    power = spec.real**2 + spec.imag**2  # [257, frames]
    logmel = torch.log(mel_bank(n_mels).to(x.device) @ power + LOG_GUARD).T  # [frames, mels]
    n = x.shape[0] // HOP
    valid = logmel[:n]
    mean = valid.mean(dim=0, keepdim=True)
    std = valid.var(dim=0, unbiased=True, keepdim=True).sqrt()
    out = torch.zeros_like(logmel)
    out[:n] = (valid - mean) / (std + NORM_EPS)
    return out


def param_shapes(cfg: dict) -> dict:
    """The checkpoint's parameter names and shapes (BatchNorm's running
    statistics among them), in the order draw_params draws them."""
    D, Fd, H = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_attention_heads"]
    C, k = cfg["subsampling_conv_channels"], cfg["subsampling_conv_kernel_size"]
    K = cfg["conv_kernel_size"]
    n_conv = int(math.log2(cfg["subsampling_factor"]))
    s = {"subsampling.layers.0.weight": (C, 1, k, k), "subsampling.layers.0.bias": (C,)}
    for j in range(n_conv - 1):
        s[f"subsampling.layers.{2 + 3 * j}.weight"] = (C, 1, k, k)
        s[f"subsampling.layers.{2 + 3 * j}.bias"] = (C,)
        s[f"subsampling.layers.{3 + 3 * j}.weight"] = (C, C, 1, 1)
        s[f"subsampling.layers.{3 + 3 * j}.bias"] = (C,)
    s["subsampling.linear.weight"] = (D, C * (cfg["num_mel_bins"] // cfg["subsampling_conv_stride"] ** n_conv))
    s["subsampling.linear.bias"] = (D,)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        for part in ("feed_forward1", "self_attn", "conv", "feed_forward2", "out"):
            if part.startswith("feed_forward"):
                s[f"{pre}norm_{part}.weight"] = (D,)
                s[f"{pre}norm_{part}.bias"] = (D,)
                s[f"{pre}{part}.linear1.weight"] = (Fd, D)
                s[f"{pre}{part}.linear1.bias"] = (Fd,)
                s[f"{pre}{part}.linear2.weight"] = (D, Fd)
                s[f"{pre}{part}.linear2.bias"] = (D,)
            elif part == "self_attn":
                s[pre + "norm_self_att.weight"] = (D,)
                s[pre + "norm_self_att.bias"] = (D,)
                for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
                    s[f"{pre}self_attn.{proj}.weight"] = (D, D)
                    s[f"{pre}self_attn.{proj}.bias"] = (D,)
                s[pre + "self_attn.relative_k_proj.weight"] = (D, D)
                s[pre + "self_attn.bias_u"] = (H, D // H)
                s[pre + "self_attn.bias_v"] = (H, D // H)
            elif part == "conv":
                s[pre + "norm_conv.weight"] = (D,)
                s[pre + "norm_conv.bias"] = (D,)
                s[pre + "conv.pointwise_conv1.weight"] = (2 * D, D, 1)
                s[pre + "conv.pointwise_conv1.bias"] = (2 * D,)
                s[pre + "conv.depthwise_conv.weight"] = (D, 1, K)
                s[pre + "conv.depthwise_conv.bias"] = (D,)
                for leaf in ("weight", "bias", "running_mean", "running_var"):
                    s[f"{pre}conv.norm.{leaf}"] = (D,)
                s[pre + "conv.pointwise_conv2.weight"] = (D, D, 1)
                s[pre + "conv.pointwise_conv2.bias"] = (D,)
            else:
                s[pre + "norm_out.weight"] = (D,)
                s[pre + "norm_out.bias"] = (D,)
    return s


def draw_params(cfg: dict, seed: int, device="cpu") -> dict:
    """Weights for a check, drawn name by name on `device` from a generator
    seeded with `seed`, none of them at a value that would hide a port
    leaving it out.  The matrices at the published initial scales: every
    Linear normal with std 0.02 (transformers' _init_weights), the convs
    Kaiming-normal (std sqrt(2 / fan_in): PyTorch's own scale; 0.02 would
    shrink the stem's signal some 10^4-fold).  In place of the published
    constants: every bias N(0, 0.02), each LayerNorm's and BatchNorm's
    weight 1 + N(0, 0.1) and bias N(0, 0.1), the running mean N(0, 0.1),
    the running variance uniform in [0.5, 2]; bias_u and bias_v N(0, 0.2)
    (published N(0, 0.02): trained ones are larger, and a check should see
    them)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def normal(shape, std, mean=0.0):
        return torch.randn(shape, generator=gen, device=device) * std + mean

    out = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if ".norm" in name or name.startswith("norm"):
            if leaf == "running_var":
                out[name] = 0.5 + 1.5 * torch.rand(shape, generator=gen, device=device)
            else:
                out[name] = normal(shape, 0.1, 1.0 if leaf == "weight" else 0.0)
        elif leaf in ("bias_u", "bias_v"):
            out[name] = normal(shape, 0.2)
        elif len(shape) >= 3:
            fan_in = 1
            for n in shape[1:]:
                fan_in *= n
            out[name] = normal(shape, math.sqrt(2.0 / fan_in))
        else:
            out[name] = normal(shape, 0.02)
    return out


def sinusoids(T: int, D: int, device) -> torch.Tensor:
    """ParakeetEncoderRelPositionalEncoding: [2T - 1, D] for positions T -
    1 down to -(T - 1), sin and cos interleaved."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, dtype=torch.int64, device=device).float() / D))
    pos = torch.arange(T - 1, -T, -1, device=device).float()
    freqs = (inv[:, None] @ pos[None, :]).T  # [2T - 1, D / 2]
    return torch.stack([freqs.sin(), freqs.cos()], dim=-1).reshape(2 * T - 1, D)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """transformers' _rel_shift of [H, T, 2T - 1] scores."""
    H, T, P = x.shape
    x = F.pad(x, (1, 0)).view(H, -1, T)
    return x[:, 1:].reshape(H, T, P)


def hidden_states(params: dict, feats: torch.Tensor, n: int, cfg: dict) -> torch.Tensor:
    """One recording's input_features [frames, mels] (on the weights'
    device), n of them valid -> the last hidden state [T, hidden_size]."""
    P = params

    def ln(name, x):
        return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], EPS)

    def lin(name, x, bias=True):
        y = x @ P[name + ".weight"].T
        return y + P[name + ".bias"] if bias else y

    def ffn(name, x):
        return lin(name + ".linear2", F.silu(lin(name + ".linear1", x)))

    k, st = cfg["subsampling_conv_kernel_size"], cfg["subsampling_conv_stride"]
    pad, C = (k - 1) // 2, cfg["subsampling_conv_channels"]
    t = torch.tensor([n], device=feats.device)

    def masked(x, t):
        keep = torch.arange(x.shape[2], device=x.device) < t[:, None]
        return x * keep[:, None, :, None]

    x = feats[None, None]
    x = F.conv2d(x, P["subsampling.layers.0.weight"], P["subsampling.layers.0.bias"], stride=st,
                 padding=pad)
    t = (t + 2 * pad - k) // st + 1
    x = F.relu(masked(x, t))
    for j in range(int(math.log2(cfg["subsampling_factor"])) - 1):
        dw, pw = f"subsampling.layers.{2 + 3 * j}", f"subsampling.layers.{3 + 3 * j}"
        x = F.conv2d(x, P[dw + ".weight"], P[dw + ".bias"], stride=st, padding=pad, groups=C)
        t = (t + 2 * pad - k) // st + 1
        x = masked(x, t)
        x = F.relu(masked(F.conv2d(x, P[pw + ".weight"], P[pw + ".bias"]), t))
    T = int(t[0])
    h = lin("subsampling.linear", x[0].transpose(0, 1).reshape(x.shape[2], -1)[:T])
    D = h.shape[1]
    if cfg.get("scale_input", True):
        h = h * math.sqrt(D)
    H = cfg["num_attention_heads"]
    dh = D // H
    scale = dh**-0.5
    pos = sinusoids(T, D, h.device)
    K = cfg["conv_kernel_size"]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        h = h + 0.5 * ffn(pre + "feed_forward1", ln(pre + "norm_feed_forward1", h))

        a = pre + "self_attn."
        x = ln(pre + "norm_self_att", h)
        q = lin(a + "q_proj", x).view(T, H, dh).transpose(0, 1)
        kk = lin(a + "k_proj", x).view(T, H, dh).transpose(0, 1)
        v = lin(a + "v_proj", x).view(T, H, dh).transpose(0, 1)
        rel = lin(a + "relative_k_proj", pos, bias=False).view(-1, H, dh).permute(1, 2, 0)
        bd = rel_shift((q + P[a + "bias_v"][:, None, :]) @ rel)[..., :T] * scale
        scores = (q + P[a + "bias_u"][:, None, :]) @ kk.transpose(1, 2) * scale + bd
        ctx = torch.softmax(scores, dim=-1) @ v  # [H, T, dh]
        h = h + lin(a + "o_proj", ctx.transpose(0, 1).reshape(T, D))

        m = pre + "conv."
        c = ln(pre + "norm_conv", h).T[None]  # [1, D, T]
        c = F.conv1d(c, P[m + "pointwise_conv1.weight"], P[m + "pointwise_conv1.bias"])
        c = F.glu(c, dim=1)
        c = F.conv1d(c, P[m + "depthwise_conv.weight"], P[m + "depthwise_conv.bias"],
                     padding=(K - 1) // 2, groups=D)
        c = F.batch_norm(c, P[m + "norm.running_mean"], P[m + "norm.running_var"],
                         P[m + "norm.weight"], P[m + "norm.bias"], training=False, eps=EPS)
        c = F.conv1d(F.silu(c), P[m + "pointwise_conv2.weight"], P[m + "pointwise_conv2.bias"])
        h = h + c[0].T

        h = h + 0.5 * ffn(pre + "feed_forward2", ln(pre + "norm_feed_forward2", h))
        h = ln(pre + "norm_out", h)
    return h


def embed(params: dict, y, cfg: dict, tf32: bool = False) -> torch.Tensor:
    """One recording (array or tensor of samples, at least 160 of them) ->
    its embedding [hidden_size]: the fbank, the encoder, the mean of the
    last hidden state over its frames; matmuls and cuDNN in TF32 only if
    `tf32`."""
    dev = params["subsampling.linear.weight"].device
    y = torch.as_tensor(y, dtype=torch.float32).to(dev)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            feats = fbank(y, cfg["num_mel_bins"])
            return hidden_states(params, feats, y.shape[0] // HOP, cfg).mean(0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
