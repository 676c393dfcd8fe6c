"""The counts of operations and bytes, against a hand count at one shape."""

import json
from pathlib import Path

import pytest

from counts import work
from counts.peaks import FP32_FLOPS, HBM_BYTES_PER_S

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def config(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_fft_and_bound():
    assert work.fft_ops(1024) == 2.5 * 1024 * 10
    assert work.bound_s(FP32_FLOPS, 0) == 1.0
    assert work.bound_s(0, HBM_BYTES_PER_S) == 1.0
    assert work.bound_s(FP32_FLOPS, 2 * HBM_BYTES_PER_S) == 2.0


def test_gate_one_second_by_hand():
    g = work._gate_cfg(config("mlp149"))
    # 500 Hz over 16000 / 512 Hz a bin: 16 -> 33 frequency taps; 50 ms over
    # 16 ms a hop: 3 -> 7 time taps
    assert (g["freq_taps"], g["time_taps"], g["pad"]) == (33, 7, 30000)
    ops, n_bytes = work.gate(16000, g)
    frames = 1 + (16000 + 60000) // 256  # 297, all run the IIR
    # frames centred at t * 256 overlapping [30000, 46000): t * 256 + 512 > 30000
    # and t * 256 - 512 < 46000, so t = 116 .. 181
    inside = 181 - 116 + 1
    per_inside = 2 * 25600 + (3 + 6 + 2 * 40 + 2 + 2) * 513 + 2 * 1024
    halo = 2 * 3  # half the 7 time taps each side: mask and frequency smoothing
    assert (frames, inside) == (297, 66)
    assert ops == (frames * 6 * 513 + inside * per_inside + halo * (6 + 2 * 33) * 513
                   + 2 * 16000)
    assert n_bytes == 8 * 16000


def test_gate_counts_the_clip_not_the_pad():
    """The zero pad adds only its IIR: a second of clip costs about four
    times less than every padded frame's whole gate would."""
    g = work._gate_cfg(config("mlp149"))
    frames = 1 + (16000 + 60000) // 256
    every_frame = frames * (2 * 25600 + (3 + 6 + 6 + 2 * 40 + 2 + 2) * 513 + 2 * 1024)
    assert 3.5 < every_frame / work.gate(16000, g)[0] < 4.5
    assert work.gate(32000, g)[0] - work.gate(16000, g)[0] > 60 * 2 * 25600


def test_features_one_second_by_hand():
    fe = config("mlp149")["frontend"]
    ops, n_bytes = work.features_149(16000, fe, mel_nonzeros=1000, chroma_nonzeros=2000,
                                     band_bins=492)
    per_frame = (56320 + 3075 + 2000 + 384 + 5120 + 720 + 20 * 492 + 4000 + 24 + 288)
    assert ops == 32 * per_frame
    assert n_bytes == 4 * (16000 + 149)


def test_piptrack_band_bins():
    # 150-4000 Hz at 16 kHz and n_fft 2048 (7.8125 Hz a bin): bins 20 .. 511
    assert work._band_bins(16000, 2048) == 492


def test_heads_by_hand():
    assert work.head("cnn", 100) == (2 * 9 * 1 * 32 * 158 * 64 + 2 * 9 * 32 * 64 * 79 * 32
                                     + 2 * 9 * 64 * 96 * 40 * 16 + 2 * 96 * 3)
    assert work.head("transformer", 100) == 54_787_392
    lstm = 2 * 25 * 2 * 192 * 4 * 96  # 100 valid frames -> 25 steps after two stride-2 convs
    assert work.head("cnn_bilstm", 100) == (2 * 5 * 60 * 64 * 158 + 2 * 5 * 64 * 96 * 79
                                            + lstm + 2 * 192 * 3)
    with pytest.raises(KeyError):
        work.head("gru", 1)


def test_padding_rows_count_no_work():
    cfg = config("mlp149")
    assert work.gate_work([0, 16000], cfg) == work.gate_work([16000], cfg)
    assert work.features_work([0, 16000], cfg) == work.features_work([16000], cfg)


def test_vote_counts_every_member():
    cfg = config("quint_vote")
    one = work.vote_ops([48000], cfg)
    heads = sum(work.head(m["arch"], 94) for m in cfg["members"].values())
    assert one > heads > 3 * 54_787_392


def test_training_step_by_hand():
    assert work.mlp_params([149, 256, 128, 64, 3]) == (149 * 256 + 256 + 256 * 128 + 128
                                                       + 128 * 64 + 64 + 64 * 3 + 3)
    assert work.mlp_params([149, 256, 128, 64, 3]) == 79_747
    assert work.train_step_ops([2, 3], 10) == 6 * (2 * 3 + 3) * 10
