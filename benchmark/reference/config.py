"""The gate's configuration, field for field the port's DenoiseConfig, so
the frozen tables (`consts.mask_smoothing_profiles`, `iir_coefficient`)
read it as the port does.  Built from a configuration file's `denoise`
group by `denoise_config`."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DenoiseConfig:
    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    prop_decrease: float = 1.0
    time_constant_s: float = 2.0
    freq_mask_smooth_hz: float = 500.0
    time_mask_smooth_ms: float = 50.0
    thresh_n_mult_nonstationary: float = 2.0
    sigmoid_slope_nonstationary: float = 10.0


def denoise_config(group: dict) -> DenoiseConfig:
    """A configuration file's `denoise` group -> DenoiseConfig; a key the
    dataclass lacks raises."""
    return DenoiseConfig(**group)
