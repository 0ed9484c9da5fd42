"""The port's acquisition front end (gnss_dsp_tpu_torch.ops.frontend)
against the JAX package's on the same capture: carrier-offset wipeoff,
161-tap zero-phase lowpass, linear resample.

Tolerance: atol 1e-4 x max|x|.  The JAX package runs the FIR as banded
float32 matmuls, the port as conv1d: the same taps summed in another
order (161 products per pass, two passes).
"""

import numpy as np
import pytest
import torch

from gnss_dsp_tpu.ops import cplx as jcplx
from gnss_dsp_tpu.ops import frontend as jfe
from gnss_dsp_tpu_torch.ops import frontend as tfe


def _capture(fs, ms, seed=11):
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq

    sig = get_signal("gps-l1")
    n = int(fs * ms / 1000)
    rng = np.random.default_rng(seed)
    x = synth_iq(sig.code_table((9,))[0].astype(np.float64), sig.chip_rate,
                 fs, n, doppler_hz=1700.0, code_phase=321.5, cn0_dbhz=None)
    x += (0.5 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    return x.astype(np.complex64)


def test_design_lowpass_identical():
    np.testing.assert_array_equal(tfe.design_lowpass(4.096e6, 0.4e6),
                                  jfe.design_lowpass(4.096e6, 0.4e6))


@pytest.mark.parametrize("coffset", [0.0, 1250.0])
def test_prepare_baseband_matches_jax(coffset):
    fs, acq_fs, ms = 4.096e6, 1.024e6, 12
    x = _capture(fs, ms + 1)
    want = jcplx.to_numpy(jfe.prepare_baseband(x, fs, coffset, acq_fs,
                                               0.4e6, ms))
    got = tfe.prepare_baseband(torch.from_numpy(x), fs, coffset, acq_fs,
                               0.4e6, ms).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert got.shape[0] == int(acq_fs * ms / 1000)
    tol = 1e-4 * np.abs(x).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_mix_long_matches_jax_across_segments():
    # seg_bits=10: 1024-sample segments, so the segment-start phases run
    x = _capture(4.096e6, 2)
    f = -3333.0 / 4.096e6
    want = jcplx.to_numpy(jfe.mix_long(jcplx.from_numpy(x), f, seg_bits=10))
    got = tfe.mix_long(torch.from_numpy(x), f, seg_bits=10).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6 * np.abs(x).max())


def test_resample_linear_matches_jax():
    x = _capture(4.096e6, 3)
    want = jcplx.to_numpy(jfe.resample_linear(jcplx.from_numpy(x), 4.096e6,
                                              1.5e6, 4000))
    got = tfe.resample_linear(torch.from_numpy(x), 4.096e6, 1.5e6,
                              4000).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
