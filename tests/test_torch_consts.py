"""The port's NumPy constant tables equal the JAX package's originals (bf16
hi/lo splits recombined where the TPU kernels split them).  The FFT kernels'
own tables (twiddles, sparse mel ranges) are held in tests/test_torch_fft.py."""

import numpy as np
import pytest
import torch

from stutter_tpu import config as jconfig
from stutter_tpu_torch.config import DenoiseConfig
from stutter_tpu_torch.ops import consts

torch.set_num_threads(2)


def _recombined(hi, lo):
    return np.asarray(hi, np.float32) + np.asarray(lo, np.float32)


@pytest.mark.parametrize("prop", [1.0, 0.8])
def test_denoise_tables_equal_jax(prop):
    from stutter_tpu.denoise import _mask_smoothing_profiles, _window_sumsquare

    cfg, jcfg = DenoiseConfig(prop_decrease=prop), jconfig.DenoiseConfig(prop_decrease=prop)
    assert consts.iir_coefficient(cfg) == consts.iir_coefficient(jcfg)
    for ours, theirs in zip(consts.mask_smoothing_profiles(cfg), _mask_smoothing_profiles(jcfg)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(consts.window_sumsquare(428, 1024, 256),
                                  _window_sumsquare(428, 1024, 256))


def test_gate_kernel_tables_equal_jax():
    """The gate kernel's synthesis (inverse real FFT times the port's Hann:
    1/N and the one-sided weights come with irfft) is the JAX kernel's IDFT
    table row for row, and its winv table is the JAX kernel's."""
    from stutter_tpu.ops.pallas_denoise import _gate_idft_consts, _gate_winv
    from stutter_tpu_torch.ops import filterbanks as fb

    cr_hi, cr_lo, ci_hi, ci_lo = _gate_idft_consts(1024)
    eye = np.eye(513)
    hann = np.asarray(fb.hann(1024), np.float64)
    # the split keeps ~16 mantissa bits; entries are O(2/N)
    np.testing.assert_allclose(_recombined(cr_hi, cr_lo), np.fft.irfft(eye, n=1024) * hann,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(_recombined(ci_hi, ci_lo), np.fft.irfft(1j * eye, n=1024) * hann,
                               rtol=0, atol=1e-8)
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
