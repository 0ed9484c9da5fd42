"""Kernels of gnss_dsp_tpu_torch against their plain versions on a CUDA
card (marked `cuda`; skipped where torch sees no card).  Imports nothing
of JAX, so on a machine without it run:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Tolerances: K1 argmax exact on planted cells, peak/sum rtol 1e-4 (float32
FFTs in another order); K2 bit-exact (the kernel and the plain version
pin the same roundings, and sum the correlators in float64).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gnss_dsp_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("W,P,DC,B", [(1024, 3, 2, 8), (4096, 4, 3, 5),
                                      (256, 2, 2, 3)])
def test_k1_matches_plain(dev, W, P, DC, B):
    from gnss_dsp_tpu_torch.ops import acquire2

    g = torch.Generator(device=dev).manual_seed(W)
    code = torch.exp(2j * np.pi * torch.rand((P, W), generator=g, device=dev)
                     ).to(torch.complex64)
    F = torch.complex(torch.randn((DC, B, W), generator=g, device=dev),
                      torch.randn((DC, B, W), generator=g, device=dev))
    k = torch.arange(W, device=dev, dtype=torch.float64)
    lags = [(p * 997 + 13) % W for p in range(P)]
    for p in range(P):
        F[p % DC] += (code[p].to(torch.complex128)
                      * torch.exp(-2j * np.pi * k * lags[p] / W)
                      ).to(torch.complex64)
    n0 = acquire2.LAUNCHES
    pk, ik, sk = acquire2.corr_surface2(F, code)
    assert acquire2.LAUNCHES == n0 + 1
    pp, ip, sp = acquire2.corr_surface2_plain(F, code)
    for p in range(P):
        assert int(ik[p, p % DC]) == int(ip[p, p % DC]) == (-lags[p]) % W
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=0)
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=0)


def test_k1_rejects_unsupported_w(dev):
    from gnss_dsp_tpu_torch.ops import acquire2

    F = torch.zeros((1, 1, 3000), dtype=torch.complex64, device=dev)
    with pytest.raises(NotImplementedError):
        acquire2.corr_surface2(F, F[0])


def test_k2_matches_plain_bit_for_bit(dev):
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq
    from gnss_dsp_tpu_torch.ops import track_fused
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import (
        init_state, sigp_from_params, track_scan, track_scan_plain)

    sig = get_signal("gps-l1")
    fs, nb = 2.048e6, 60
    prns, dops, phases = [7, 13, 21], [900.0, -2200.0, 350.0], [0.01, 417.25,
                                                                 1010.5]
    n = int(fs * 0.07)
    x = sum(synth_iq(sig.code_table((p,))[0].astype(np.float64),
                     sig.chip_rate, fs, n, doppler_hz=d, code_phase=c,
                     cn0_dbhz=None, carrier_ratio=1540.0)
            for p, d, c in zip(prns, dops, phases)).astype(np.complex64)
    params = make_params(sig, fs, coffset=1250.0, loop_dwells=(8, 8))
    xp = np.concatenate([x, np.zeros(params.nmax + 1024, np.complex64)])
    xd = torch.from_numpy(xp).to(dev)
    tab = torch.from_numpy(sig.code_table(tuple(prns)).astype(np.int8)).to(dev)
    extra = (torch.full((3,), 1540.0, device=dev),
             torch.full((3,), params.coffset_df_fixed, dtype=torch.int32,
                        device=dev),
             sigp_from_params(params, 3, dev))

    def both(st, chunk_len, nblocks):
        n0 = track_fused.LAUNCHES
        k = track_scan(xd, chunk_len, tab, st, params, nblocks)
        assert track_fused.LAUNCHES == n0 + 1
        cl = torch.full((3,), chunk_len, dtype=torch.int32, device=dev)
        p = track_scan_plain(xd, cl, tab, st, params, nblocks, *extra)
        torch.testing.assert_close(k[2], p[2], rtol=0, atol=0)
        torch.testing.assert_close(k[1], p[1], rtol=0, atol=0,
                                   equal_nan=True)
        for a, b in zip(k[0], p[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        return k[0]

    # the chunk ends mid-run: every channel stalls, then a refill
    st = both(init_state(phases, [0.0] * 3, [0.0] * 3, dops, device=dev),
              int(fs * 0.030), nb)
    assert bool(st.stalled.all())
    st = both(st._replace(stalled=torch.zeros_like(st.stalled)), n, 30)
    assert not bool(st.stalled.any())
