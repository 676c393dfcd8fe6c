"""The port's NumPy constant tables equal the JAX package's originals (bf16
hi/lo splits recombined where the TPU kernels split them)."""

import numpy as np
import pytest
import torch

from stutter_tpu.config import DenoiseConfig
from stutter_tpu_torch.ops import consts

torch.set_num_threads(2)


def _recombined(hi, lo):
    return np.asarray(hi, np.float32) + np.asarray(lo, np.float32)


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (1024, 256), (512, 256)])
def test_chunk_tables_equal_jax(n_fft, hop):
    from stutter_tpu.ops.spectral import _chunk_dft_mats, _chunk_phase_tables

    for ours, theirs in zip(consts.chunk_dft_mats(n_fft, hop), _chunk_dft_mats(n_fft, hop)):
        np.testing.assert_array_equal(ours, theirs)
    for ours, theirs in zip(consts.chunk_phase_tables(n_fft, hop),
                            _chunk_phase_tables(n_fft, hop)):
        np.testing.assert_array_equal(ours, theirs)


def test_chunk_tables_match_kernel_splits():
    from stutter_tpu.ops.pallas_spectromel import _chunk_dft_mats_bf16

    cos_hi, cos_lo, sin_hi, sin_lo = _chunk_dft_mats_bf16(2048, 512)
    cos_c, sin_c = consts.chunk_dft_mats(2048, 512)
    np.testing.assert_allclose(_recombined(cos_hi, cos_lo), cos_c, rtol=0, atol=2e-5)
    np.testing.assert_allclose(_recombined(sin_hi, sin_lo), sin_c, rtol=0, atol=2e-5)


@pytest.mark.parametrize("prop", [1.0, 0.8])
def test_denoise_tables_equal_jax(prop):
    from stutter_tpu.denoise import _mask_smoothing_profiles, _window_sumsquare

    cfg = DenoiseConfig(prop_decrease=prop)
    for ours, theirs in zip(consts.mask_smoothing_profiles(cfg), _mask_smoothing_profiles(cfg)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(consts.window_sumsquare(428, 1024, 256),
                                  _window_sumsquare(428, 1024, 256))


def test_gate_kernel_tables_equal_jax():
    from stutter_tpu.ops.pallas_denoise import _gate_idft_consts, _gate_winv

    cr_hi, cr_lo, ci_hi, ci_lo = _gate_idft_consts(1024)
    cr, ci = consts.idft_mats(1024)
    # the split keeps ~16 mantissa bits; entries are O(2/N)
    np.testing.assert_allclose(_recombined(cr_hi, cr_lo), cr, rtol=0, atol=1e-8)
    np.testing.assert_allclose(_recombined(ci_hi, ci_lo), ci, rtol=0, atol=1e-8)
    for t_frames in (252, 428, 876):
        np.testing.assert_array_equal(consts.ola_winv(t_frames, 1024, 256),
                                      _gate_winv(t_frames, 1024, 256))


def test_tuning_tables_equal_jax():
    from stutter_tpu.ops.chroma import _band_range, _residual_table
    from stutter_tpu.ops.pallas_chroma import _fb_table_rows

    assert consts.band_range(16000, 2048, 150.0, 4000.0) == _band_range(16000, 2048, 150.0, 4000.0)
    assert consts.band_range(16000, 2048, 150.0, 4000.0) == (20, 512)
    np.testing.assert_array_equal(consts.residual_table(16000, 2048, 1025, 12),
                                  _residual_table(16000, 2048, 1025, 12))
    np.testing.assert_array_equal(consts.fb_table_rows(16000, 2048, 12),
                                  _fb_table_rows(16000, 2048, 12))


@pytest.mark.parametrize("t_max", [49, 97])
def test_savgol_taps_rebuild_the_kernel_operators(t_max):
    """The banded [T, T] operators of pallas_spectromel._stat_consts (bf16
    split) are the port's interior + first-edge taps; its last-edge rows
    are the port's last-edge taps."""
    from stutter_tpu.ops.pallas_spectromel import _stat_consts

    mats, lasts = _stat_consts(t_max, 20, 128)
    taps = consts.savgol_taps(9)
    for o in range(2):
        interior, first, last = taps[o, 0], taps[o, 1:5], taps[o, 5:]
        S = np.zeros((t_max, t_max), np.float64)
        for t in range(4, t_max):
            for j in range(9):
                if 0 <= t + j - 4 < t_max:
                    S[t, t + j - 4] = interior[j]
        S[:4, :9] = first
        np.testing.assert_allclose(_recombined(mats[2 + 2 * o], mats[3 + 2 * o]), S,
                                   rtol=0, atol=1e-5 * np.abs(S).max())
        np.testing.assert_array_equal(np.asarray(lasts[o], np.float32), last)
