"""Frozen copy of stutter_tpu_torch/models/cnn_bilstm.py (plain PyTorch), for the benchmark's reference.

CNN-BiLSTM head over the MFCC+delta+delta2 stack (counterpart of
stutter_tpu/models/cnn_bilstm.py).

Two stride-2 width-5 1-D convs (64, 96 channels), a bidirectional LSTM of
width 96, a masked mean pool and a dense head.  The JAX package scans the
LSTM step by step (`_lstm_scan`, gates i, f, g, o, +1 on the forget gate);
a masked step carries h and c through unchanged, and the backward
direction runs on the time-reversed padded sequence.  With a prefix mask
(every serving path's) that is a plain LSTM over each clip's valid frames
in both directions, so here it is `torch.nn.LSTM` over a packed sequence:
the JAX bias in `bias_ih`, the +1 in the forget slice of `bias_hh`, and the
LSTM's weights kept there only.  The valid lengths come
from the host's clip lengths (`n_valid`), never from a copy off the
device.  Hidden states at padded steps differ from the scan's (zeros here,
the carried state there); the pool never reads them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from .layers import Params, conv1d_same, masked_mean


_DIRECTIONS = (("fwd", ""), ("bwd", "_reverse"))  # JAX name -> nn.LSTM suffix


class CNNBiLSTM(Params):
    """The LSTM's weights live in `self.lstm` only (not in `self.p`), so an
    optimizer step on them is what `to_jax_params` exports."""

    layouts = {r"conv\d+": (2, 1, 0)}  # WIO -> OIW

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__({k: v for k, v in params.items() if not k.startswith("lstm_")})
        wh = params["lstm_fwd_wh"]
        hidden = wh.shape[0]
        self.lstm = nn.LSTM(params["lstm_fwd_wx"].shape[0], hidden, batch_first=True,
                            bidirectional=True, device=wh.device)
        with torch.no_grad():
            for d, sfx in _DIRECTIONS:
                getattr(self.lstm, f"weight_ih_l0{sfx}").copy_(params[f"lstm_{d}_wx"].T)
                getattr(self.lstm, f"weight_hh_l0{sfx}").copy_(params[f"lstm_{d}_wh"].T)
                getattr(self.lstm, f"bias_ih_l0{sfx}").copy_(params[f"lstm_{d}_b"])
                getattr(self.lstm, f"bias_hh_l0{sfx}").copy_(self._forget())
        self.requires_grad_(False)

    def requires_grad_(self, requires_grad: bool = True) -> "CNNBiLSTM":
        """Gradients on or off for every weight but `bias_hh`: the JAX
        scan has one bias per direction (`bias_ih` here), and `bias_hh`
        holds only its forget +1, which a step must not move (a trained
        `bias_hh` would take the bias's gradient a second time)."""
        super().requires_grad_(requires_grad)
        for _, sfx in _DIRECTIONS:
            getattr(self.lstm, f"bias_hh_l0{sfx}").requires_grad_(False)
        return self

    def _forget(self) -> torch.Tensor:
        """The JAX scan's +1 on the forget gate (gates i, f, g, o); nn.LSTM
        adds bias_ih + bias_hh, and bias_hh starts as this."""
        h = self.lstm.hidden_size
        forget = torch.zeros(4 * h, device=self.lstm.weight_hh_l0.device)
        forget[h : 2 * h] = 1.0
        return forget

    def hidden_states(self, x: torch.Tensor, n_valid) -> torch.Tensor:
        """x [B, T, C], n_valid [B] host ints >= 1 (a prefix mask) ->
        [B, T, 2H] forward | backward hidden states, zero past n_valid."""
        lengths = torch.as_tensor(np.asarray(n_valid), dtype=torch.int64)
        packed = pack_padded_sequence(x, lengths, batch_first=True, enforce_sorted=False)
        h, _ = pad_packed_sequence(self.lstm(packed)[0], batch_first=True,
                                   total_length=x.shape[1])
        return h

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, n_valid) -> torch.Tensor:
        """feats [B, T, D] (standardized MFCC+delta+delta2), mask [B, T], the
        prefix mask of n_valid [B] valid frames (host ints) -> logits [B, C]."""
        x = feats
        nv = np.asarray(n_valid, np.int64)
        n_conv = sum(1 for k in self.p if k.startswith("conv"))
        for i in range(n_conv):
            x = x * mask.to(x.dtype)[:, :, None]
            x = conv1d_same(x.transpose(1, 2), self.p[f"conv{i}"]).transpose(1, 2)
            x = torch.relu(x + self.p[f"cb{i}"])
            mask = mask[:, ::2]
            nv = (nv + 1) // 2  # valid entries of mask[:, ::2]
        h = self.hidden_states(x, np.maximum(nv, 1))
        return masked_mean(h, mask) @ self.p["w_out"] + self.p["b_out"]
