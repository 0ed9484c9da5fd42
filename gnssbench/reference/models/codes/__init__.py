# Frozen copy of gnss_dsp_tpu_torch/models/codes/__init__.py at commit 196026d.
# Changed: imports point at gnssbench.reference.models.
"""Host-side PRN code-table builders (numpy; built once, device-resident).

Every builder returns int8 chips in {-1,+1} (the reference keeps {0,1}
and maps 1-2c at use sites, e.g. gps/ca.py:112).  Builders are memoized
in-process; long codes (GLONASS P) are additionally cached on disk.
"""

from __future__ import annotations

import numpy as np


def resample_host(code_pm1: np.ndarray, chips: float, frac: float, incr: float, n: int) -> np.ndarray:
    """Floor-indexed fractional-rate code resampler, float64 host oracle.

    Behavioral contract: gps/ca.py:106-112 — idx = floor((chips mod L) +
    frac + incr*i) mod L; the engines use this to build FFT reference
    waveforms and test oracles."""
    L = code_pm1.shape[-1]
    idx = (chips % L) + frac + incr * np.arange(n, dtype=np.float64)
    idx = np.floor(idx).astype(np.int64) % L
    return code_pm1[..., idx].astype(np.float64)
