"""The port's acquisition (gnss_dsp_tpu_torch) against the JAX package.

  * kernel K1's plain version against the TPU kernel
    pallas_acquire2.corr_surface2(reduce=True) run in interpret mode, on
    the same bf16-rounded spectra: argmax exact on the planted cells,
    peak and sum to rtol 5e-3 (the TPU kernel's inverse DFT runs as bf16
    matmuls, the acquisition engine's stated bf16 budget);
  * acquire_signal against the JAX one on the tiny GPS L1 configuration
    of __graft_entry__.py: PRN, doppler and code offset exact, metric to
    rtol 1e-4 (float32 FFTs in another order);
  * the doppler chunking does not change the winning cell (first maximum
    inside a chunk, strict > across chunks).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch import interop
from gnss_dsp_tpu_torch.ops import acquire2


def _planted_spectra(rng, P, DC, B, W, plants):
    """Unit-modulus code spectra and noisy data spectra where
    code_f[p] * conj(F[d, b]) carries e^{+2 pi i k j/W} for each planted
    (p, d, j)."""
    code = np.exp(2j * np.pi * rng.random((P, W)))
    F = 0.7 * (rng.standard_normal((DC, B, W))
               + 1j * rng.standard_normal((DC, B, W)))
    k = np.arange(W)
    for p, d, j in plants:
        F[d] += 0.5 * code[p] * np.exp(-2j * np.pi * k * j / W)
    return code, F


def test_k1_plain_matches_pallas_kernel_interpret():
    import jax.numpy as jnp

    from gnss_dsp_tpu.ops import pallas_acquire2 as pa2

    W, P, DC, B = 1024, 3, 2, 8
    n1, n2 = pa2.plan_aligned(W)
    assert (n1, n2) == (8, 128)
    g = pa2.pick_g(n1)                 # the kernel takes blocks in groups
    Bp = -(-B // g) * g                # zero blocks add exactly nothing
    rng = np.random.default_rng(21)
    plants = [(0, 0, 77), (1, 1, 1000), (2, 0, 513)]
    code, F = _planted_spectra(rng, P, DC, B, W, plants)
    F = np.concatenate([F, np.zeros((DC, Bp - B, W))], axis=1)

    def bf16_perm(a):
        ap = pa2.permute_host2(a, n1, n2)
        return (jnp.asarray(ap.real.astype(np.float32)).astype(jnp.bfloat16),
                jnp.asarray(ap.imag.astype(np.float32)).astype(jnp.bfloat16))

    F16, C16 = bf16_perm(F), bf16_perm(code)
    peak_j, idx_j, sum_j = (np.asarray(v) for v in pa2.corr_surface2(
        F16, C16, n1=n1, n2=n2, bt=g, reduce=True, interpret=True))

    def natural(split):
        return interop.code_ffts_from_split(
            np.asarray(split[0], np.float32), np.asarray(split[1], np.float32),
            plan=("v2", n1, n2))

    Ft = natural(F16)[:, :B].contiguous()
    Ct = natural(C16)
    peak_t, idx_t, sum_t = acquire2.corr_surface2(Ft, Ct)
    assert peak_t.shape == (P, DC) and idx_t.dtype == torch.int32
    for p, d, j in plants:
        assert int(idx_t[p, d]) == int(idx_j[p, d]) == (-j) % W
    np.testing.assert_allclose(peak_t.numpy(), peak_j, rtol=5e-3)
    np.testing.assert_allclose(sum_t.numpy(), sum_j, rtol=5e-3)


def _tiny_gps_l1():
    from gnss_dsp_tpu.models import get_signal

    sig = get_signal("gps-l1")
    return dataclasses.replace(sig, acq_fs=1.024e6, acq_lowpass_hz=0.4e6)


def _tiny_capture(sig, ms=10):
    from gnss_dsp_tpu.utils.synth import synth_iq

    fs = sig.acq_fs
    n = int(fs * ms / 1000)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in ((1, 1500.0, 123.0), (3, -500.0, 700.25),
                         (7, 1000.0, 5.0)):
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                      doppler_hz=dop, code_phase=cp, cn0_dbhz=None,
                      carrier_ratio=sig.carrier_ratio)
    return x


def test_acquire_signal_matches_jax():
    from gnss_dsp_tpu.acquire import engine as jeng
    from gnss_dsp_tpu_torch.acquire import engine as teng

    sig = _tiny_gps_l1()
    x = _tiny_capture(sig)
    prns = (1, 2, 3, 7)
    grid = (-2000.0, 2000.0, 500.0)
    want = jeng.acquire_signal(sig, x, prns, doppler_search=grid, ms=8)
    got = teng.acquire_signal(sig, torch.from_numpy(x), prns,
                              doppler_search=grid, ms=8)
    for a, b in zip(want, got):
        assert (b.prn, b.doppler, b.code_offset) == \
            (a.prn, a.doppler, a.code_offset)
        assert abs(b.metric - a.metric) <= 1e-4 * abs(a.metric)
    assert [r.prn for r in got] == list(prns)
    # the three planted PRNs win their cells
    assert {r.prn: r.doppler for r in got if r.prn != 2} == \
        {1: 1500.0, 3: -500.0, 7: 1000.0}


def test_grid_search_chunking_does_not_move_the_winner():
    from gnss_dsp_tpu_torch.acquire import engine as teng

    sig = _tiny_gps_l1()
    x = torch.from_numpy(_tiny_capture(sig))
    n = int(sig.acq_fs * 1e-3)
    cf = torch.from_numpy(teng.build_code_ffts(sig, (1, 3, 7, 9), n, n)
                          .astype(np.complex64))
    _, fixed = teng.doppler_grid(sig, (-2000.0, 2000.0, 250.0))
    fixed = torch.from_numpy(fixed.astype(np.int64))
    runs = [teng.grid_search(x, cf, fixed, n=n, window=n, blocks=8,
                             peak_mean=True, dop_chunk=c)
            for c in (None, 1, 3, 7)]
    for r in runs[1:]:
        for a, b in zip(runs[0], r):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
