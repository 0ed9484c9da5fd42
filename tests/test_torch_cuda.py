"""Kernels of gnss_dsp_tpu_torch against their plain versions on a CUDA
card (marked `cuda`; skipped where torch sees no card).  Imports nothing
of JAX, so on a machine without it run:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

Tolerances: K1 argmax exact on planted cells, peak/sum rtol 1e-4 (float32
FFTs in another order, and at a W that is not a power of two one division
by W of the block sum against a 1/W scale per transform), two launches
bit-equal, and an exact tie across cluster ranks to the lowest lag; K1's
surface (reduce=False) and K7 planted lags
exact, the surface to rtol 1e-4 plus 2e-5 of its maximum; K2 bit-exact at
every subcarrier kind, sub-block count, long code and coherent (the kernel
and the plain version pin the same roundings, and sum the correlators in
float64); K5 and K6
idx and align exact on the planted cells, peak rtol 1e-4 (K6's kernel
sums each group's blocks before the IDFT, its plain version after), K5
at every window the coherent route sends it, two launches bit-equal, and
an exact tie across ranks and alignments to the lowest lag, then the
lowest alignment (K6 also across alignment chunks, whose merge is
bit-equal to one cluster walking every alignment; K5's batched core at
16384 also across its two yb buffers, bit-equal to surface_rows' build
there, each launch counted by core); K3
and K4 equal to their plain version to one float32 ulp of the channel's
largest sum (both sum exact float64 products and round once; a sum within
2^-29 of a rounding tie may round the other way), two launches bit-equal,
and bit-equal to the host emulation of their order of summation
(tests/test_torch_track_step_plan.step_sums); a K3 launch replayed from a
CUDA graph bit-equal to an eager one.  The squaring detector and the
correlation-shape probe on card tensors against their CPU results (rtol
1e-5); K2 on a whole preloaded band (cli/track._preload_chunk) bit-equal
to the plain scan; K7 at 61380 as the single-card route under
GNSS_DSP_NO_V2P, with the padded route's winners.  The streaming track
ingest (pinned staging slots, chunks built on the card): every chunk
track_file and track_receiver hand the scan bit-equal to the CPU run's,
the rows equal to one chunk over the whole capture on the card, and a
second call in the process allocating no pinned memory and uploading
every byte from it.  The rows' text (csrc/track_rows.cu) byte for byte
the row-by-row path's, head and all, on seed-drawn rows and on a K2 scan
of GPS L1.
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
                                      (256, 2, 2, 3), (16384, 3, 2, 4)])
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

    F = torch.zeros((1, 1, 7 * 13 * 64), dtype=torch.complex64, device=dev)
    with pytest.raises(NotImplementedError):
        acquire2.corr_surface2(F, F[0])


def _planted(dev, P, DC, B, W, lo, seed):
    """Unit-modulus code spectra and noise spectra F [DC, B, W]; PRN p
    planted at doppler p % DC and lag j = lo + (997p + 13) % (W - lo):
    code_f[p] * conj(F[d, b]) carries e^{-2 pi i k j/W}."""
    g = torch.Generator(device=dev).manual_seed(seed)
    code = torch.exp(2j * np.pi * torch.rand((P, W), generator=g, device=dev)
                     ).to(torch.complex64)
    F = torch.complex(torch.randn((DC, B, W), generator=g, device=dev),
                      torch.randn((DC, B, W), generator=g, device=dev))
    k = torch.arange(W, device=dev, dtype=torch.float64)
    lags = [lo + (p * 997 + 13) % (W - lo) for p in range(P)]
    for p in range(P):
        F[p % DC] += (code[p].to(torch.complex128)
                      * torch.exp(2j * np.pi * k * lags[p] / W)
                      ).to(torch.complex64)
    return code, F, lags


@pytest.mark.parametrize("W,n_valid,P,DC,B", [
    (32768, 15345, 3, 2, 3), (65536, 30690, 2, 2, 3), (65536, 0, 3, 2, 2),
    (81920, 0, 2, 3, 2), (163840, 0, 2, 2, 2), (1280, 640, 5, 3, 4),
    (30690, 0, 3, 2, 3), (4608, 2000, 40, 10, 3)])
def test_k1_wide_matches_plain(dev, W, n_valid, P, DC, B):
    from gnss_dsp_tpu_torch.ops import acquire2

    lo = W - n_valid if n_valid else 0
    code, F, lags = _planted(dev, P, DC, B, W, lo, W + n_valid)
    n0 = acquire2.LAUNCHES
    pk, ik, sk = acquire2.corr_surface2(F, code, n_valid)
    assert acquire2.LAUNCHES == n0 + 1
    pp, ip, sp = acquire2.corr_surface2_plain(F, code, n_valid)
    for p in range(P):
        assert int(ik[p, p % DC]) == int(ip[p, p % DC]) == lags[p] - lo
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=0)
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=0)
    again = acquire2.corr_surface2(F, code, n_valid)   # same bits each run
    for a, b in zip((pk, ik, sk), again):
        assert torch.equal(a, b)


# the windows acquire/plan.acq_plan sends K1, each with its route's n_valid
# (v2p) and without, at every cluster size built there (81920 on 8 CTAs:
# the run-time core)
K1_WINDOWS = [(4096, 0, c) for c in (2, 1, 4, 8)] + [
    (16384, 0, 8), (32768, 15345, 8), (32768, 0, 16), (65536, 30690, 16),
    (65536, 0, 16), (65536, 30690, 8), (81920, 0, 16), (81920, 0, 8),
    (163840, 0, 0)]


@pytest.mark.parametrize("W,n_valid,cluster", K1_WINDOWS)
def test_k1_at_every_window(dev, W, n_valid, cluster):
    """K1 on its core and cluster size at each window of the catalog
    (P 3, DC 2, B 2): planted lags exact, peak and sum rtol 1e-4, two
    launches bit-equal, one launch a call."""
    from gnss_dsp_tpu_torch.ops import acquire2

    info = acquire2.launch_info(W, dev.index or 0, cluster)
    assert (info["core"], info["n1"], info["n2"], info["cluster"]) == \
        acquire2.core_plan(W, cluster)
    lo = W - n_valid if n_valid else 0
    code, F, lags = _planted(dev, 3, 2, 2, W, lo, W + n_valid + cluster)
    n0 = acquire2.LAUNCHES
    got = acquire2.corr_surface2(F, code, n_valid, cluster=cluster)
    assert acquire2.LAUNCHES == n0 + 1
    plain = acquire2.corr_surface2_plain(F, code, n_valid)
    for p in range(3):
        assert int(got[1][p, p % 2]) == int(plain[1][p, p % 2]) == lags[p] - lo
    torch.testing.assert_close(got[0], plain[0], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[2], plain[2], rtol=1e-4, atol=0)
    again = acquire2.corr_surface2(F, code, n_valid, cluster=cluster)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def k1_tie(dev, W, B=2, cluster=0):
    """K1 on a row whose surface ties exactly at every lag j with an even
    row index j mod n1 (X = code * conj(F) = delta[0] + delta[(n1/2) n2]:
    the column IDFT is 1 + (-1)^j1 on column 0 alone, and every product
    the kernel forms is by a unit twiddle or by zero).  Searched from lag
    0, the lowest tied lag is 0, owned by rank 0; from lo = nr - 1 (the
    last row of rank 0, odd) it is nr, owned by rank 1, while rank 0
    owns the tied lag n1.  Returns ((idx from 0, idx from lo), the plain
    version's and the kernel's (peak, idx, sum) from 0, nr)."""
    from gnss_dsp_tpu_torch.ops import acquire2

    _, n1, n2, C = acquire2.core_plan(W, cluster)
    nr = -(-n1 // C)
    code = torch.ones((1, W), dtype=torch.complex64, device=dev)
    F = torch.zeros((1, B, W), dtype=torch.complex64, device=dev)
    F[:, :, 0] = 1.0
    F[:, :, (n1 // 2) * n2] = 1.0
    out = []
    for n_valid in (0, W - (nr - 1)):
        got = acquire2.corr_surface2(F, code, n_valid, cluster=cluster)
        out.append((int(got[1][0, 0]), got))
    plain = acquire2.corr_surface2_plain(F, code, 0)
    return (out[0][0], out[1][0]), plain, out[0][1], nr


@pytest.mark.parametrize("W,cluster", [(4096, 2), (4096, 8), (16384, 8),
                                       (32768, 8), (32768, 16), (65536, 16),
                                       (65536, 8), (81920, 16),
                                       (81920, 8), (163840, 0)])
def test_k1_tie_across_ranks_takes_the_lowest_lag(dev, W, cluster):
    (i0, i1), plain, got, nr = k1_tie(dev, W, cluster=cluster)
    assert (i0, i1) == (0, 1)           # lag 0; lag nr from lo = nr - 1
    torch.testing.assert_close(got[0], plain[0], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[2], plain[2], rtol=1e-4, atol=0)


@pytest.mark.parametrize("W,P,DC,B", [(30690, 2, 3, 4), (1280, 3, 2, 5),
                                      (65536, 1, 2, 2), (960, 30, 12, 2)])
def test_k7_matches_plain(dev, W, P, DC, B):
    from gnss_dsp_tpu_torch.ops import acquire

    code, F, lags = _planted(dev, P, DC, B, W, 0, W + 7)
    n0 = acquire.LAUNCHES
    qk = acquire.corr_surface(F, code)
    assert acquire.LAUNCHES == n0 + 1 and qk.shape == (P, DC, W)
    qp = acquire.corr_surface_plain(F, code)
    for p in range(P):
        assert int(qk[p, p % DC].argmax()) == lags[p]
    torch.testing.assert_close(qk, qp, rtol=1e-4,
                               atol=2e-5 * float(qp.max()))
    assert torch.equal(qk, acquire.corr_surface(F, code))


def test_k7_cluster_at_x5_is_deterministic(dev):
    """K7 at Xona X5's window (30690 = 165 x 186, a cluster of 4 CTAs) on
    a small grid: planted lags exact, the plain version to rtol 1e-4 plus
    2e-5 of the maximum, two launches bit-equal, and the same at 6 CTAs
    a cluster (uneven row shares)."""
    from gnss_dsp_tpu_torch.ops import acquire

    W, P, DC, B = 30690, 1, 2, 3
    code, F, lags = _planted(dev, P, DC, B, W, 0, 4242)
    assert acquire.launch_info(P, DC, B, W, dev.index or 0)["cluster"] == 4
    qk = acquire.corr_surface(F, code)
    qp = acquire.corr_surface_plain(F, code)
    assert int(qk[0, 0].argmax()) == lags[0]
    torch.testing.assert_close(qk, qp, rtol=1e-4,
                               atol=2e-5 * float(qp.max()))
    assert torch.equal(qk, acquire.corr_surface(F, code))
    q6 = acquire.corr_surface(F, code, cluster=6)
    torch.testing.assert_close(q6, qp, rtol=1e-4,
                               atol=2e-5 * float(qp.max()))


# the windows the sharded search's route (acquire/plan.mesh_plan) sends
# K1's surface, at every cluster size built there (81920 on 8 CTAs: the
# run-time core)
K1_SURFACE_WINDOWS = [(4096, c) for c in (2, 1, 4, 8)] + [
    (16384, 8), (32768, 8), (32768, 16), (65536, 8), (65536, 16),
    (81920, 16), (81920, 8), (163840, 0)]


@pytest.mark.parametrize("W,cluster", K1_SURFACE_WINDOWS)
def test_k1_surface_matches_plain(dev, W, cluster):
    """K1 with reduce=False (the natural-order surface) on its core and
    cluster size (P 3, DC 2, B 2): planted lags exact, the surface to rtol
    1e-4 plus 2e-5 of its maximum (K7's tolerance: float32 FFTs in another
    order), its max and sum to the reduction's at rtol 1e-4, two launches
    bit-equal, one launch a call on its own counter."""
    from gnss_dsp_tpu_torch.ops import acquire2

    info = acquire2.launch_info(W, dev.index or 0, cluster, False)
    assert (info["core"], info["n1"], info["n2"], info["cluster"]) == \
        acquire2.core_plan(W, cluster)
    code, F, lags = _planted(dev, 3, 2, 2, W, 0, W + cluster + 1)
    n0, n1 = acquire2.LAUNCHES_SURFACE, acquire2.LAUNCHES
    q = acquire2.corr_surface2(F, code, 0, False, cluster=cluster)
    assert (acquire2.LAUNCHES_SURFACE, acquire2.LAUNCHES) == (n0 + 1, n1)
    assert q.shape == (3, 2, W) and q.dtype == torch.float32
    qp = acquire2.corr_surface_plain(F, code)
    for p in range(3):
        assert int(q[p, p % 2].argmax()) == int(qp[p, p % 2].argmax()) \
            == lags[p]
    torch.testing.assert_close(q, qp, rtol=1e-4, atol=2e-5 * float(qp.max()))
    peak, _, sm = acquire2.corr_surface2(F, code, cluster=cluster)
    torch.testing.assert_close(q.amax(dim=-1), peak, rtol=1e-4, atol=0)
    torch.testing.assert_close(q.sum(dim=-1), sm, rtol=1e-4, atol=0)
    assert torch.equal(q, acquire2.corr_surface2(F, code, 0, False,
                                                 cluster=cluster))


def test_k7_at_the_sharded_pad2_window(dev):
    """K7 at 61380 = 220 x 279, the sharded search's window of the pad2
    signals (GPS L5, Galileo E5, BeiDou B2a/B2b/B3I, GLONASS L3OC): a
    cluster of 8 CTAs by the kernel's choice (the most CTAs busy at once)
    and 7, the fewest that hold the row, by request; planted
    lags exact, the plain version to rtol 1e-4 plus 2e-5 of the maximum,
    two launches bit-equal."""
    from gnss_dsp_tpu_torch.ops import acquire

    W, P, DC, B = 61380, 2, 3, 3
    code, F, lags = _planted(dev, P, DC, B, W, 0, 6138)
    info = acquire.launch_info(P, DC, B, W, dev.index or 0)
    assert (info["n1"], info["n2"], info["cluster"]) == (220, 279, 8)
    qp = acquire.corr_surface_plain(F, code)
    for c in (0, 7):
        qk = acquire.corr_surface(F, code, cluster=c)
        for p in range(P):
            assert int(qk[p, p % DC].argmax()) == lags[p]
        torch.testing.assert_close(qk, qp, rtol=1e-4,
                                   atol=2e-5 * float(qp.max()))
        assert torch.equal(qk, acquire.corr_surface(F, code, cluster=c))


def test_k7_refuses_cpu_tensors_and_unsupported_w(dev):
    from gnss_dsp_tpu_torch.ops import acquire

    n0 = acquire.LAUNCHES
    F = torch.zeros((1, 2, 30690), dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA"):
        acquire.corr_surface(F, F[0])
    F = torch.zeros((1, 2, 7 * 13 * 64), dtype=torch.complex64, device=dev)
    with pytest.raises(NotImplementedError):
        acquire.corr_surface(F, F[0])
    assert acquire.LAUNCHES == n0


def _coh_inputs(dev, P, DC, B, W, A, n_valid, seed, sec=None):
    """Unit-modulus code spectra, noise spectra F [DC, B, W], rotations
    and overlay signs (random, or `sec`); PRN p planted at doppler p %
    DC, alignment (3p + 1) % A and lag j = lo + (997p + 13) % (W - lo)
    among the searched lags j >= lo = W - n_valid, coherent across blocks (F_m
    carries sec[a, m] rot[d, m] code e^{+2 pi i k j/W})."""
    g = torch.Generator(device=dev).manual_seed(seed)
    code = torch.exp(2j * np.pi * torch.rand((P, W), generator=g, device=dev)
                     ).to(torch.complex64)
    F = 0.3 * torch.complex(torch.randn((DC, B, W), generator=g, device=dev),
                            torch.randn((DC, B, W), generator=g, device=dev))
    ang = 2 * np.pi * torch.rand((DC, B), generator=g, device=dev)
    sec = (np.random.default_rng(seed).choice([-1.0, 1.0], A)
           if sec is None else np.asarray(sec))
    sec_mat = torch.from_numpy(
        sec[(np.arange(A)[:, None] + np.arange(B)[None, :]) % A]
        .astype(np.float32)).to(dev)
    k = torch.arange(W, device=dev, dtype=torch.float64)
    lo = W - n_valid if n_valid else 0
    plants = [(p, p % DC, (3 * p + 1) % A, lo + (997 * p + 13) % (W - lo))
              for p in range(P)]
    for p, d, a, j in plants:
        ramp = code[p].to(torch.complex128) * torch.exp(
            2j * np.pi * k * j / W)
        rot = torch.exp(1j * ang[d].to(torch.float64))         # [B]
        F[d] += (0.5 * sec_mat[a].to(torch.float64)[:, None] * rot[:, None]
                 * ramp[None]).to(torch.complex64)
    return code, F, torch.cos(ang), torch.sin(ang), sec_mat, plants


def _check_planted(got, plain, plants, W, n_valid):
    lo = W - n_valid if n_valid else 0
    for p, d, a, j in plants:
        want = (j - lo, a)
        assert (int(got[1][p, d]), int(got[2][p, d])) == want
        assert (int(plain[1][p, d]), int(plain[2][p, d])) == want
    torch.testing.assert_close(got[0], plain[0], rtol=1e-4, atol=0)


@pytest.mark.parametrize("W,P,DC,A,m_coh,G,n_valid", [
    (4096, 3, 2, 1, 8, 2, 0), (2048, 3, 3, 4, 4, 2, 900),
    (16384, 2, 2, 20, 20, 2, 0), (256, 1, 2, 100, 100, 1, 0)])
def test_k6_matches_plain(dev, W, P, DC, A, m_coh, G, n_valid):
    from gnss_dsp_tpu_torch.ops import acquire_coh

    code, F, c, s, sec_mat, plants = _coh_inputs(dev, P, DC, G * m_coh, W,
                                                 A, n_valid, W + A)
    n0 = acquire_coh.LAUNCHES_BLK
    got = acquire_coh.corr_surface_coh(F, code, c, s, sec_mat, m_coh, n_valid)
    assert acquire_coh.LAUNCHES_BLK == n0 + 1
    plain = acquire_coh.corr_surface_coh_plain(F, code, c, s, sec_mat, m_coh,
                                               n_valid)
    _check_planted(got, plain, plants, W, n_valid)


@pytest.mark.parametrize("W,P,DC,A,m_coh,G,n_valid,chunks", [
    (4096, 1, 3, 100, 100, 2, 0, (1, 7, 25, 100)),
    (2048, 2, 2, 10, 5, 3, 700, (1, 3, 10)),
    (8, 3, 2, 300, 4, 2, 0, (64, 300))])
def test_k6_alignment_split_is_bit_equal(dev, W, P, DC, A, m_coh, G, n_valid,
                                         chunks):
    """The surface stage with the alignments split over clusters (their
    (peak, lag, alignment) merged by one 64-bit atomicMax) gives the bits
    of one cluster walking all of them, one launch count a call, and the
    plain version's planted cells."""
    from gnss_dsp_tpu_torch.ops import acquire_coh

    code, F, c, s, sec_mat, plants = _coh_inputs(dev, P, DC, G * m_coh, W,
                                                 A, n_valid, W + 3 * A)
    whole = acquire_coh.corr_surface_coh(F, code, c, s, sec_mat, m_coh,
                                         n_valid, a_chunk=A)
    plain = acquire_coh.corr_surface_coh_plain(F, code, c, s, sec_mat, m_coh,
                                               n_valid)
    _check_planted(whole, plain, plants, W, n_valid)
    for ch in chunks:
        n0 = acquire_coh.LAUNCHES_BLK
        got = acquire_coh.corr_surface_coh(F, code, c, s, sec_mat, m_coh,
                                           n_valid, a_chunk=ch)
        assert acquire_coh.LAUNCHES_BLK == n0 + 1
        for a, b in zip(got, whole):
            assert torch.equal(a, b), ch


@pytest.mark.parametrize("W,P,DC,A,m_coh,G,n_valid", [
    (4096, 2, 3, 1, 8, 2, 0), (4096, 1, 2, 100, 100, 2, 0),
    (1024, 2, 2, 20, 20, 1, 600), (2, 1, 2, 130, 3, 2, 0)])
def test_k6_combines_match_plain(dev, W, P, DC, A, m_coh, G, n_valid):
    """The combine the kernel takes (the streaming sum at A = 1, 3xTF32
    mma.sync at A >= 2, its 130 alignments over two CTAs)
    against the plain version: planted cells exact, peak rtol 1e-4."""
    from gnss_dsp_tpu_torch.ops import acquire_coh

    code, F, c, s, sec_mat, plants = _coh_inputs(dev, P, DC, G * m_coh, W,
                                                 A, n_valid, W + A)
    got = acquire_coh.corr_surface_coh(F, code, c, s, sec_mat, m_coh,
                                       n_valid)
    plain = acquire_coh.corr_surface_coh_plain(F, code, c, s, sec_mat, m_coh,
                                               n_valid)
    _check_planted(got, plain, plants, W, n_valid)


def test_k1_and_k6_at_the_sensitivity_window(dev):
    """The sensitivity curve's kernels at W = 8192 (BeiDou B1I at 4.096
    MHz, tools/sensitivity_curve), at its launch shape of one PRN x 9
    dopplers x 40 blocks: K1 on the run-time core, one CTA (8192 has no
    register build), and K6 at m_coh = A = 20 (the B1I overlay) on K5's
    register core of 8 CTAs in alignment chunks: each core the host's
    plan, planted cells exact, metrics rtol 1e-4, two launches
    bit-equal."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import acquire2, acquire_coh

    W = 8192
    info = acquire2.launch_info(W, dev.index or 0)
    assert (info["core"], info["n1"], info["n2"], info["cluster"]) == \
        acquire2.core_plan(W) == ("wide", 64, 128, 1)
    code, F, lags = _planted(dev, 1, 9, 40, W, 0, W)
    got = acquire2.corr_surface2(F, code)
    plain = acquire2.corr_surface2_plain(F, code)
    assert int(got[1][0, 0]) == int(plain[1][0, 0]) == lags[0]
    torch.testing.assert_close(got[0], plain[0], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[2], plain[2], rtol=1e-4, atol=0)
    for a, b in zip(got, acquire2.corr_surface2(F, code)):
        assert torch.equal(a, b)
    sinfo = acquire_coh.spec_launch_info(W, dev.index or 0)
    assert (sinfo["core"], sinfo["cluster"], sinfo["n1"], sinfo["n2"]) == \
        ("split", 8, 64, 128)
    b1i = get_signal("beidou-b1i")
    code, F, c, s, sec_mat, plants = _coh_inputs(
        dev, 1, 9, 40, W, 20, 0, W + 20, sec=b1i.secondary(34))
    n0 = acquire_coh.LAUNCHES_BLK
    got = acquire_coh.corr_surface_coh(F, code, c, s, sec_mat, 20)
    assert acquire_coh.LAUNCHES_BLK == n0 + 1
    plain = acquire_coh.corr_surface_coh_plain(F, code, c, s, sec_mat, 20)
    _check_planted(got, plain, plants, W, 0)
    for a, b in zip(got, acquire_coh.corr_surface_coh(F, code, c, s,
                                                      sec_mat, 20)):
        assert torch.equal(a, b)


def test_k6_surface_takes_k1s_build_at_4096(dev):
    """K6's surface stage is K5's launch, on K1's 2-CTA build at 4096 (the
    card's plan equals the host's), against the plain version at the GPS
    L1 --coherent 8 group shape."""
    from gnss_dsp_tpu_torch.ops import acquire_coh

    info = acquire_coh.spec_launch_info(4096, dev.index or 0)
    assert (info["core"], info["cluster"], info["n1"], info["n2"]) == \
        ("split", 2, 64, 64)
    code, F, c, s, sec_mat, plants = _coh_inputs(dev, 3, 2, 16, 4096, 1, 0, 2)
    got = acquire_coh.corr_surface_coh(F, code, c, s, sec_mat, 8)
    plain = acquire_coh.corr_surface_coh_plain(F, code, c, s, sec_mat, 8)
    _check_planted(got, plain, plants, 4096, 0)


@pytest.mark.parametrize("a_chunk", [1, 2, 5])
def test_k6_keeps_the_lowest_lag_then_alignment_on_a_tie(dev, a_chunk):
    """K6 at 4096 (2 CTAs a cluster, 32 rows a rank) on rows whose
    surfaces tie exactly at every lag with an even j mod n1 (delta[0] +
    delta[(n1/2) n2], every product by a unit twiddle or by zero), one
    block a group, no rotation, alignments 1-4 equal and alignment 0 at
    half: the kernel reports lag 0 at alignment 1, and from lo = 31 lag
    32 (rank 1, over rank 0's lag 64), alignment 1, however the
    alignments are split."""
    from gnss_dsp_tpu_torch.ops import acquire_coh

    W, G, A = 4096, 2, 5
    code = torch.ones((1, W), dtype=torch.complex64, device=dev)
    F = torch.zeros((1, G, W), dtype=torch.complex64, device=dev)
    F[:, :, 0] = 1.0
    F[:, :, 32 * 64] = 1.0
    sec = np.array([[0.5, 0.5], [1, -1], [-1, 1], [1, 1], [-1, -1]])
    sec_mat = torch.from_numpy(sec.astype(np.float32)).to(dev)
    one = torch.ones((1, G), device=dev)
    zero = torch.zeros((1, G), device=dev)
    cells = []
    for nv in (0, W - 31):
        got = acquire_coh.corr_surface_coh(F, code, one, zero, sec_mat, 1, nv,
                                           a_chunk=a_chunk)
        cells.append((int(got[1][0, 0]), int(got[2][0, 0])))
    assert cells == [(0, 1), (1, 1)]
    plain = acquire_coh.corr_surface_coh_plain(F, code, one, zero, sec_mat, 1)
    torch.testing.assert_close(got[0], plain[0], rtol=1e-4, atol=0)


@pytest.mark.parametrize("W,P,DC,A,G,n_valid", [
    (16384, 3, 2, 4, 2, 0), (1024, 3, 3, 1, 3, 0), (8192, 2, 2, 5, 2, 5000),
    (512, 1, 2, 100, 2, 0)])
def test_k5_matches_plain(dev, W, P, DC, A, G, n_valid):
    from gnss_dsp_tpu_torch.ops import acquire_coh

    # combined rows: group g, alignment a = sum_m conj(w[a, m]) F_m
    code, F, c, s, sec_mat, plants = _coh_inputs(dev, P, DC, G * A, W, A,
                                                 n_valid, W + 7 * A)
    wc = sec_mat[None] * torch.complex(c, -s)[:, None, :]      # [DC, A, B]
    F2 = torch.einsum("dagm,dgmw->dgaw", wc.reshape(DC, A, G, A),
                      F.reshape(DC, G, A, W)).reshape(DC, G * A, W)
    n0 = acquire_coh.LAUNCHES_SPEC
    got = acquire_coh.corr_surface_coh_spec(F2, code, A, n_valid)
    assert acquire_coh.LAUNCHES_SPEC == n0 + 1
    plain = acquire_coh.corr_surface_coh_spec_plain(F2, code, A, n_valid)
    _check_planted(got, plain, plants, W, n_valid)


def test_k5_cluster_keeps_the_lowest_alignment_on_a_tie(dev):
    """K5 at W = 16384 (a cluster of 8 CTAs), P 2, DC 3, G 2, A 3, with a
    planted tie across alignments: at doppler 1 alignments 0 and 2 hold
    the same rows, so their surfaces are equal at every lag and the
    kernel must report alignment 0, as _finalize_max does; the other
    cells as the plain version (idx and align exact on the plants, peak
    rtol 1e-4), and the same at 4 CTAs a cluster (the run-time core: 4
    CTAs have no register build at 16384)."""
    from gnss_dsp_tpu_torch.ops import acquire_coh

    W, P, DC, A, G = 16384, 2, 3, 3, 2
    code, F, c, s, sec_mat, plants = _coh_inputs(dev, P, DC, G * A, W, A, 0,
                                                 16384 + 3)
    # combined rows g*A + a (as test_k5_matches_plain): the plants add
    # coherently (1.5) at their own alignment only
    wc = sec_mat[None] * torch.complex(c, -s)[:, None, :]      # [DC, A, B]
    F2 = torch.einsum("dagm,dgmw->dgaw", wc.reshape(DC, A, G, A),
                      F.reshape(DC, G, A, W)).reshape(DC, G * A, W)
    F2[1, 2::A] = F2[1, 0::A]
    k = torch.arange(W, device=dev, dtype=torch.float64)
    F2[1, 0::A] += (3.0 * code[1].to(torch.complex128)
                    * torch.exp(2j * np.pi * k * 777 / W)
                    ).to(torch.complex64)
    F2[1, 2::A] = F2[1, 0::A]
    assert acquire_coh.spec_launch_info(W, dev.index or 0)["cluster"] == 8
    got = acquire_coh.corr_surface_coh_spec(F2, code, A)
    plain = acquire_coh.corr_surface_coh_spec_plain(F2, code, A)
    assert (int(got[1][1, 1]), int(got[2][1, 1])) == (777, 0)
    assert (int(plain[1][1, 1]), int(plain[2][1, 1])) == (777, 0)
    for p, d, a, j in plants:
        if d != 1:
            assert (int(got[1][p, d]), int(got[2][p, d])) == (j, a)
    torch.testing.assert_close(got[0], plain[0], rtol=1e-4, atol=0)
    got4 = acquire_coh.corr_surface_coh_spec(F2, code, A, cluster=4)
    for a, b in zip(got, got4):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=0)


def _combined_rows(dev, code, F, c, s, sec_mat, G, A):
    """K5's rows F2 [DC, G*A, W] combined from F as K6's combine does
    (row g*A + a = sum_m conj(w[a, m]) F_m over the group's A blocks)."""
    DC, B, W = F.shape
    wc = sec_mat[None] * torch.complex(c, -s)[:, None, :]      # [DC, A, B]
    return torch.einsum("dagm,dgmw->dgaw", wc.reshape(DC, A, G, A),
                        F.reshape(DC, G, A, W)).reshape(DC, G * A, W)


# K5's batched core at 16384: the b1i-weak cell's launch (63 PRNs x 51
# dopplers x 2 groups of 20 alignments), GLONASS --coherent 8's (1 x 16 x
# 10 groups, one alignment), 2 x 3 x 6 rows (A = 3, G = 2), nine rows (an
# odd count: the last row in the first yb buffer) and n_valid
K5_BATCHED = [(63, 51, 20, 2, 0), (1, 16, 1, 10, 0), (2, 3, 3, 2, 0),
              (3, 4, 3, 3, 0), (4, 5, 3, 2, 9000)]


@pytest.mark.parametrize("P,DC,A,G,n_valid", K5_BATCHED)
def test_k5_batched_core_matches_plain(dev, P, DC, A, G, n_valid):
    """The batched core (the card's plan: 8 CTAs) against the plain
    version: idx and align exact on the plants, peak rtol 1e-4;
    surface_rows' build at 16384 (the ablation, the other windows' core)
    and a second launch bit-equal to it."""
    from gnss_dsp_tpu_torch.ops import acquire_coh

    W = acquire_coh.BATCHED_W
    info = acquire_coh.spec_launch_info(W, dev.index or 0)
    assert (info["core"], info["n1"], info["n2"], info["cluster"]) \
        == ("split", 128, 128, 8)
    # at A = 3 an overlay whose cyclic shifts differ (a constant one
    # would tie every alignment)
    code, F, c, s, sec_mat, plants = _coh_inputs(
        dev, P, DC, G * A, W, A, n_valid, W + 7 * A + G,
        sec=[1.0, 1.0, -1.0] if A == 3 else None)
    F2 = _combined_rows(dev, code, F, c, s, sec_mat, G, A)
    del F
    got = acquire_coh.corr_surface_coh_spec(F2, code, A, n_valid)
    plain = acquire_coh.corr_surface_coh_spec_plain(F2, code, A, n_valid)
    _check_planted(got, plain, plants, W, n_valid)
    for other in (acquire_coh.corr_surface_coh_spec(F2, code, A, n_valid,
                                                    surface_rows=True),
                  acquire_coh.corr_surface_coh_spec(F2, code, A, n_valid)):
        for a, b in zip(got, other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("surface_rows", [False, True])
@pytest.mark.parametrize("G,A", [(1, 3), (3, 3)])
def test_k5_batched_tie_across_yb_buffers(dev, surface_rows, G, A):
    """Alignments 1 and 2 hold the same rows, so their surfaces tie at
    every lag, with a strong cell at lag 777: the batched core reports
    alignment 1, as _finalize_max does, where the tied alignments' rows
    pass through different yb buffers (at G = 1 alignment 1's row is in
    the second buffer and 2's in the first; at G = 3 each one's groups
    use both), and so does surface_rows' build (the ablation)."""
    from gnss_dsp_tpu_torch.ops import acquire_coh

    W = acquire_coh.BATCHED_W
    g = torch.Generator(device=dev).manual_seed(surface_rows * 10 + G)
    code = torch.exp(2j * np.pi * torch.rand((2, W), generator=g, device=dev)
                     ).to(torch.complex64)
    F2 = torch.complex(torch.randn((2, G * A, W), generator=g, device=dev),
                       torch.randn((2, G * A, W), generator=g, device=dev))
    k = torch.arange(W, device=dev, dtype=torch.float64)
    F2[1, 1::A] += (3.0 * code[0].to(torch.complex128)
                    * torch.exp(2j * np.pi * k * 777 / W)).to(torch.complex64)
    F2[:, 2::A] = F2[:, 1::A]
    got = acquire_coh.corr_surface_coh_spec(F2, code, A,
                                            surface_rows=surface_rows)
    plain = acquire_coh.corr_surface_coh_spec_plain(F2, code, A)
    assert (int(got[1][0, 1]), int(got[2][0, 1])) == (777, 1)
    assert (int(plain[1][0, 1]), int(plain[2][0, 1])) == (777, 1)
    assert not (got[2] == 2).any() and not (plain[2] == 2).any()
    torch.testing.assert_close(got[0], plain[0], rtol=1e-4, atol=0)


def test_k5_counts_each_launch_by_core(dev, tmp_path):
    """Under a trace each K5 launch counts acq.k5.core.batched (the
    batched core at 16384) or acq.k5.core.other (16384 on surface_rows'
    build, the ablation, and on 4 CTAs, the run-time core; 8192 on
    surface_rows)."""
    from gnss_dsp_tpu_torch.ops import acquire_coh
    from gnss_dsp_tpu_torch.utils import profiling

    def rows(W):
        return (torch.ones((1, W), dtype=torch.complex64, device=dev),
                torch.ones((1, 2, W), dtype=torch.complex64, device=dev))

    with profiling.trace(str(tmp_path)):
        code, F2 = rows(16384)
        acquire_coh.corr_surface_coh_spec(F2, code, 1)
        acquire_coh.corr_surface_coh_spec(F2, code, 1, surface_rows=True)
        acquire_coh.corr_surface_coh_spec(F2, code, 1, cluster=4)
        code, F2 = rows(8192)
        acquire_coh.corr_surface_coh_spec(F2, code, 2)
    got = profiling.counts()
    assert (got.get("acq.k5.core.batched"), got.get("acq.k5.core.other")) \
        == (1, 3)


# K5 at the windows the coherent route sends it past 16384, with and
# without n_valid, on every cluster size built there and the run-time
# core (81920 on 8 CTAs, 163840)
K5_WIDE = [(32768, 15345, 8), (32768, 0, 16), (65536, 30690, 8),
           (65536, 30690, 16), (65536, 0, 8), (81920, 0, 16), (81920, 0, 8),
           (163840, 0, 0)]


@pytest.mark.parametrize("W,n_valid,cluster", K5_WIDE)
def test_k5_wide_matches_plain(dev, W, n_valid, cluster):
    """K5 at P 2, DC 2, G 2, A 3 on its core at each wide window: the
    planted (lag, alignment) exact, peak rtol 1e-4, two launches
    bit-equal, one launch a call; the rows walked alignment-major (g*A +
    a) on both cores."""
    from gnss_dsp_tpu_torch.ops import acquire_coh

    info = acquire_coh.spec_launch_info(W, dev.index or 0, cluster)
    assert (info["core"], info["n1"], info["n2"], info["cluster"]) == \
        acquire_coh.spec_core_plan(W, cluster)
    P, DC, A, G = 2, 2, 3, 2
    # an overlay whose cyclic shifts differ (a constant one would tie
    # every alignment)
    code, F, c, s, sec_mat, plants = _coh_inputs(dev, P, DC, G * A, W, A,
                                                 n_valid, W + cluster,
                                                 sec=[1.0, 1.0, -1.0])
    wc = sec_mat[None] * torch.complex(c, -s)[:, None, :]      # [DC, A, B]
    F2 = torch.einsum("dagm,dgmw->dgaw", wc.reshape(DC, A, G, A),
                      F.reshape(DC, G, A, W)).reshape(DC, G * A, W)
    n0 = acquire_coh.LAUNCHES_SPEC
    got = acquire_coh.corr_surface_coh_spec(F2, code, A, n_valid,
                                            cluster=cluster)
    assert acquire_coh.LAUNCHES_SPEC == n0 + 1
    plain = acquire_coh.corr_surface_coh_spec_plain(F2, code, A, n_valid)
    _check_planted(got, plain, plants, W, n_valid)
    again = acquire_coh.corr_surface_coh_spec(F2, code, A, n_valid,
                                              cluster=cluster)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("W,cluster", [(32768, 8), (32768, 16), (65536, 8),
                                       (65536, 16), (81920, 16), (81920, 8),
                                       (163840, 0)])
def test_k5_tie_takes_the_lowest_lag_then_alignment(dev, W, cluster):
    """K5 on rows whose surface ties exactly at every lag with an even row
    index j mod n1 (k1_tie's rows), alignment 0 at half of them and
    alignments 1 and 2 equal: from lag 0 it reports (lag 0, alignment 1),
    from lo = nr - 1 lag nr, made by rank 1 while rank 0 makes the tied
    lag n1: (idx 1, alignment 1)."""
    from gnss_dsp_tpu_torch.ops import acquire_coh

    _, n1, n2, C = acquire_coh.spec_core_plan(W, cluster)
    nr = -(-n1 // C)
    A, G = 3, 2
    code = torch.ones((1, W), dtype=torch.complex64, device=dev)
    F2 = torch.zeros((1, G * A, W), dtype=torch.complex64, device=dev)
    F2[:, :, 0] = 1.0
    F2[:, :, (n1 // 2) * n2] = 1.0
    F2[:, 0::A] *= 0.5
    cells = []
    for n_valid in (0, W - (nr - 1)):
        got = acquire_coh.corr_surface_coh_spec(F2, code, A, n_valid,
                                                cluster=cluster)
        cells.append((int(got[1][0, 0]), int(got[2][0, 0])))
        if not n_valid:
            plain = acquire_coh.corr_surface_coh_spec_plain(F2, code, A)
            torch.testing.assert_close(got[0], plain[0], rtol=1e-4, atol=0)
    assert cells == [(0, 1), (1, 1)]


def test_k1_runtime_core_launches_are_bit_equal(dev):
    """K1 at 163840 on the run-time core (wide_rows, shared with K5):
    P 2, DC 3, B 5, with and without n_valid, two launches bit-equal and
    the planted lags exact."""
    from gnss_dsp_tpu_torch.ops import acquire2

    W = 163840
    assert acquire2.core_plan(W)[0] == "wide"
    for n_valid in (0, 81920):
        lo = W - n_valid if n_valid else 0
        code, F, lags = _planted(dev, 2, 3, 5, W, lo, 11 + n_valid)
        got = acquire2.corr_surface2(F, code, n_valid)
        again = acquire2.corr_surface2(F, code, n_valid)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        for p in range(2):
            assert int(got[1][p, p % 3]) == lags[p] - lo


def test_coh_kernels_reject_unsupported_w(dev):
    """K5 refuses a window with no split into the passes' radices, K6
    any window past 16384."""
    from gnss_dsp_tpu_torch.ops import acquire_coh

    F = torch.zeros((1, 2, 7 * 13 * 64), dtype=torch.complex64, device=dev)
    with pytest.raises(NotImplementedError, match="5824"):
        acquire_coh.corr_surface_coh_spec(F, F[0], 1)
    F = torch.zeros((1, 2, 32768), dtype=torch.complex64, device=dev)
    one = torch.ones((1, 2), device=dev)
    with pytest.raises(NotImplementedError):
        acquire_coh.corr_surface_coh(F, F[0], one, one, one, 2)


def _k2_both(dev, x, tab, st, params, chunk_len, nblocks, extra, cluster):
    """K2 on `cluster` CTAs a channel, twice (bit-equal launches, one
    count each), against its plain version bit for bit; returns K2's
    result."""
    from gnss_dsp_tpu_torch.ops import track_fused
    from gnss_dsp_tpu_torch.track.engine import track_scan_plain

    cl = torch.as_tensor(chunk_len, dtype=torch.int32, device=dev)
    cl = torch.broadcast_to(cl, (tab.shape[0],)).contiguous()
    n0 = track_fused.LAUNCHES
    k = track_fused.track_scan_fused(x, cl, tab, st, params, nblocks, *extra,
                                     cluster=cluster)
    k2 = track_fused.track_scan_fused(x, cl, tab, st, params, nblocks,
                                      *extra, cluster=cluster)
    assert track_fused.LAUNCHES == n0 + 2
    p = track_scan_plain(x, cl, tab, st, params, nblocks, *extra)
    torch.testing.assert_close(k[2], p[2], rtol=0, atol=0)
    torch.testing.assert_close(k[1], p[1], rtol=0, atol=0, equal_nan=True)
    for a, b in zip(k[0], p[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(k2[1], k[1], rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(k2[2], k[2], rtol=0, atol=0)
    for a, b in zip(k2[0], k[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    return k


def _k2_gps_l1(dev, extra_samples=1024):
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.utils.synth import synth_iq
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import init_state, sigp_from_params

    sig = get_signal("gps-l1")
    fs = 2.048e6
    prns, dops, phases = [7, 13, 21], [900.0, -2200.0, 350.0], [0.01, 417.25,
                                                                 1010.5]
    n = int(fs * 0.07)
    x = sum(synth_iq(sig.code_table((p,))[0].astype(np.float64),
                     sig.chip_rate, fs, n, doppler_hz=d, code_phase=c,
                     cn0_dbhz=None, carrier_ratio=1540.0)
            for p, d, c in zip(prns, dops, phases)).astype(np.complex64)
    params = make_params(sig, fs, coffset=1250.0, loop_dwells=(8, 8))
    xp = np.concatenate([x, np.zeros(params.nmax + extra_samples,
                                     np.complex64)])
    tab = torch.from_numpy(sig.code_table(tuple(prns)).astype(np.int8)).to(dev)
    extra = (torch.full((3,), 1540.0, device=dev),
             torch.full((3,), params.coffset_df_fixed, dtype=torch.int32,
                        device=dev),
             sigp_from_params(params, 3, dev))
    st = init_state(phases, [0.0] * 3, [0.0] * 3, dops, device=dev)
    return xp, n, fs, tab, params, extra, st


@pytest.mark.parametrize("cluster", [1, 2, 4, 16])
def test_k2_matches_plain_bit_for_bit(dev, cluster):
    xp, n, fs, tab, params, extra, st = _k2_gps_l1(dev)
    xd = torch.from_numpy(xp).to(dev)
    # the chunk ends mid-run: every channel stalls, then a refill
    st = _k2_both(dev, xd, tab, st, params, int(fs * 0.030), 60, extra,
                  cluster)[0]
    assert bool(st.stalled.all())
    st = _k2_both(dev, xd, tab, st._replace(stalled=torch.zeros_like(
        st.stalled)), params, n, 30, extra, cluster)[0]
    assert not bool(st.stalled.any())


@pytest.mark.parametrize("cluster", [1, 4, 16])
def test_k2_prefetch_clamped_at_the_end_of_x(dev, cluster):
    """A chunk that ends nmax samples before the end of an odd-length x,
    handed to the kernel as a view 8 bytes into its storage: the windows
    staged for the blocks past the chunk's end are clamped into x (and
    stop at its even length), the channels stall there, and a refill
    runs on; all bit-equal to the plain version."""
    xp, n, fs, tab, params, extra, st = _k2_gps_l1(dev, extra_samples=1)
    store = torch.from_numpy(np.concatenate([np.zeros(1, np.complex64), xp])
                             ).to(dev)
    xd = store[1:]
    assert xd.shape[0] % 2 == 1 and xd.data_ptr() % 16 == 8
    k = _k2_both(dev, xd, tab, st, params, int(fs * 0.030), 60, extra,
                 cluster)
    st = k[0]
    assert bool(st.stalled.all())
    last = xd.shape[0] - params.nmax
    k = _k2_both(dev, xd, tab, st._replace(stalled=torch.zeros_like(
        st.stalled)), params, last, 60, extra, cluster)
    assert bool(k[0].stalled.all())
    assert bool((k[0].ptr > last - params.nmax).all())


# K2 at each subcarrier kind and sub-block count, across the long codes'
# wrap (L2CL, GLONASS P with two FDMA channels), and coherent (B1I, M = 20)
# over a chunk boundary mid-period: (signal, channels, fs, M)
_K2_CASES = [("galileo-e1b", 3, 4.096e6, 1), ("gps-l1cp", 2, 4.096e6, 1),
             ("gps-l2cm", 2, 4.096e6, 1), ("gps-l2cl", 2, 2.048e6, 1),
             ("glonass-l1-p", 2, 4.096e6, 1), ("beidou-b1i", 3, 4.096e6, 20)]


@pytest.mark.parametrize("cluster", [1, 2, 4, 16])
@pytest.mark.parametrize("name,C,fs,coh", _K2_CASES)
def test_k2_families_match_plain_bit_for_bit(dev, name, C, fs, coh, cluster):
    """As test_k2_matches_plain_bit_for_bit, on scan_inputs' capture (45
    dB-Hz, each code 2-40 ms before its end): a first launch whose chunk
    ends at 45 ms (coherent: 24.5 periods after each channel's start, 4
    blocks into a period), so that every channel stalls, then the
    refill."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.track_all import scan_inputs

    d = scan_inputs(name, C, fs, 0.08, 5, dev, coherent_blocks=coh)
    p = d["params"]
    assert p.fused_scan and p.coh_blocks == coh
    extra = (d["ratios"], d["cdf"], d["sigp"], d["overlay"])
    st, rows = d["st"], []
    full = torch.full((C,), d["n"], dtype=torch.int32, device=dev)
    first = (d["st"].ptr + int(24.5 * fs * 1e-3) if coh > 1
             else torch.full_like(full, int(fs * 0.045)))
    for cl, nb in ((first, 60), (full, 60)):
        k = _k2_both(dev, d["x"], d["tab"], st, p, cl, nb, extra, cluster)
        assert bool(k[0].stalled.all())
        if len(rows) == 0 and coh > 1:
            assert bool((k[0].block % coh == 4).all())
        rows.append(k[2])
        st = k[0]._replace(stalled=torch.zeros_like(k[0].stalled))
    ri = torch.cat(rows)
    assert bool((ri[:, :, 0] > 0).sum(0).ge(35).all())
    L = get_signal(name).code_length
    if L > 10230:                     # the code's end passed in every channel
        assert bool((ri[:, :, 2] == L).any(0).all())
    if coh > 1:
        assert bool((st.cacc != 0).any())


# subcarrier coefficient lanes (a0, a1, a6, tm) of the K3 kinds: "subc" for
# each affine family (track/engine.SUBC_COEF), "tmboc" the gate
_K3_CASES = [("none", (1.0, 0.0, 0.0, 0.0)), ("subc", (0.0, 1.0, 0.0, 0.0)),
             ("subc", (0.0, 0.953463, 0.301511, 0.0)),
             ("subc", (0.5, 0.5, 0.0, 0.0)), ("subc", (0.5, -0.5, 0.0, 0.0)),
             ("tmboc", (0.0, 0.0, 0.0, 1.0))]


def _step_inputs(dev, C, L, n, nmax, coef, seed, cf=1.023e6 / 4.096e6):
    """si/sf lanes of one tracking step for C channels (channel 0 at
    code phase ~0, so its early lag reads chip -1 -> L-1), a random chunk
    and a random +-1 code."""
    rng = np.random.default_rng(seed)
    nx = nmax + 3000
    x = (rng.standard_normal(nx) + 1j * rng.standard_normal(nx)
         ).astype(np.complex64)
    code = rng.choice([-1, 1], (C, L)).astype(np.int8)
    si = np.zeros((C, 9), np.int32)
    sf = np.zeros((C, 8), np.float32)
    el = 0.2
    for c in range(C):
        cp = 0.05 if c == 0 else float(rng.uniform(0, L))
        for k, lag in enumerate((-el, 0.0, el)):
            si[c, k] = int(np.floor(cp + lag))
            sf[c, k] = np.float32(cp + lag - np.floor(cp + lag))
        si[c, 3] = int(rng.integers(-(1 << 20), 1 << 20))
        si[c, 4] = n - 7 * c
        si[c, 5] = int(rng.integers(-(1 << 31), 1 << 31))
        si[c, 6] = int(rng.integers(-(1 << 20), 1 << 20))
        si[c, 7] = int(rng.integers(-(1 << 31), 1 << 31))
        si[c, 8] = int(rng.integers(0, nx - nmax))
        sf[c, 3] = np.float32(cf * (1 + 1e-6 * c))
        sf[c, 4:] = coef
    return tuple(torch.from_numpy(a).to(dev) for a in (si, sf, x, code))


def _check_step(got, want):
    env = want.abs().amax(dim=1, keepdim=True)
    ulp = torch.nextafter(env, torch.full_like(env, float("inf"))) - env
    assert bool(((got - want).abs() <= ulp).all()), (got - want).abs().max()


def _emulated(si, sf, x, code, nmax, sub, v1=False):
    """The kernel's sums in its own order of summation, emulated on the
    host (tests/test_torch_track_step_plan.step_sums) from the plain
    version's float64 terms."""
    from gnss_dsp_tpu_torch.ops import track_step
    from test_torch_track_step_plan import step_sums

    terms = torch.stack(track_step._epl_terms(si, sf, x, code, nmax, sub,
                                              v1), dim=1).cpu().numpy()
    S = track_step.step_plan(si.shape[0])["cluster"]
    lanes = si.cpu().numpy()
    out = []
    for c in range(si.shape[0]):
        ptr = int(lanes[c, track_step.SI_PTR])
        n = min(int(lanes[c, track_step.SI_N]), nmax, x.shape[0] - ptr)
        out.append(step_sums(terms[c], ptr, n, S))
    return torch.from_numpy(np.stack(out)).to(si.device)


@pytest.mark.parametrize("case", range(len(_K3_CASES)))
@pytest.mark.parametrize("C,L,n,nmax,cf", [
    (3, 1023, 4100, 6148, 0.25), (2, 767_250, 2046, 3076, 0.125),
    (2, 5_110_000, 46_000, 46_100, 5.11 / 30.69)])
def test_k3_matches_plain(dev, case, C, L, n, nmax, cf):
    from gnss_dsp_tpu_torch.ops import track_step

    kind, coef = _K3_CASES[case]
    si, sf, x, code = _step_inputs(dev, C, L, n, nmax, coef, case + L, cf)
    n0 = track_step.LAUNCHES_V2
    got = track_step.epl_correlate2(si, sf, x, code, nmax, kind)
    assert track_step.LAUNCHES_V2 == n0 + 1 and got.shape == (C, 6)
    want = track_step.epl_correlate_plain(si, sf, x, code, nmax, kind)
    _check_step(got, want)
    assert torch.equal(got, track_step.epl_correlate2(si, sf, x, code, nmax,
                                                      kind))
    assert torch.equal(got, _emulated(si, sf, x, code, nmax, kind))


@pytest.mark.parametrize("family", ["none", "boc11", "cboc", "tmboc",
                                    "rz_even", "rz_odd"])
def test_k4_matches_plain(dev, family):
    from gnss_dsp_tpu_torch.ops import track_step

    si, sf, x, code = _step_inputs(dev, 3, 10230, 8200, 12292,
                                   (0.0, 0.0, 0.0, 0.0), 99)
    n0 = track_step.LAUNCHES_V1
    got = track_step.epl_correlate(si, sf[:, :4].contiguous(), x, code,
                                   12292, family)
    assert track_step.LAUNCHES_V1 == n0 + 1
    want = track_step.epl_correlate_plain(si, sf, x, code, 12292, family,
                                          v1=True)
    _check_step(got, want)
    # the whole [C, 8] sf (read with its row stride), and a second launch
    assert torch.equal(got, track_step.epl_correlate(si, sf, x, code, 12292,
                                                     family))
    assert torch.equal(got, _emulated(si, sf, x, code, 12292, family, True))
    # every static family is one of K3's runtime forms
    kind, coef = {"none": _K3_CASES[0], "boc11": _K3_CASES[1],
                  "cboc": _K3_CASES[2], "rz_even": _K3_CASES[3],
                  "rz_odd": _K3_CASES[4], "tmboc": _K3_CASES[5]}[family]
    sf[:, 4:] = torch.tensor(coef, device=dev)
    assert torch.equal(want, track_step.epl_correlate_plain(
        si, sf, x, code, 12292, kind))


def test_k3_launch_replays_in_a_cuda_graph(dev):
    """One K3 launch captured by torch.cuda.CUDAGraph and replayed on new
    inputs copied into the captured buffers: equal to an eager launch."""
    from gnss_dsp_tpu_torch.ops import track_step

    kind, coef = _K3_CASES[1]
    si, sf, x, code = _step_inputs(dev, 32, 1023, 4100, 6148, coef, 5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        track_step.epl_correlate2(si, sf, x, code, 6148, kind)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = track_step.epl_correlate2(si, sf, x, code, 6148, kind)
    for seed in (6, 7):
        for dst, src in zip((si, sf, x, code), _step_inputs(
                dev, 32, 1023, 4100, 6148, coef, seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, track_step.epl_correlate2(si, sf, x, code,
                                                          6148, kind))


@pytest.mark.parametrize("v1", [False, True])
def test_step_call_launches_one_kernel(dev, v1):
    """A K3 (K4, as the per-step engine calls it) call at the bench shape
    launches one device kernel: no second pass, no copy, no scratch.  A
    CUDA graph captured from one call holds one node, the step kernel; and
    torch.profiler's kernel list names no other kernel."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools import timing
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import kernel_correlate

    si, sf, x, code = _step_inputs(dev, 32, 1023, 4100, 6148,
                                   _K3_CASES[0][1], 8)
    params = make_params(get_signal("gps-l1"), 4.096e6, 0.0)._replace(
        fused_scan=False, pallas_v2=not v1)
    assert params.nmax == 6148
    kern = kernel_correlate(params)
    call = lambda: kern(si, sf, x, code)
    nodes = timing.graph_nodes(call)
    assert len(nodes) == 1 and "step_kernel" in nodes[0][1], nodes
    names = timing.profiled_kernels(call, 5)
    assert all("step_kernel" in k for k in names), names


@pytest.mark.parametrize("name,v1", [("galileo-e1b", False),
                                     ("gps-l1cp", True), ("gps-l1", False)])
def test_step_scan_matches_plain(dev, name, v1):
    """The per-step route on the card (K3, or K4) against the plain loop
    over 60 blocks of a noiseless capture, across a stall and a refill."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import track_step
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import (
        init_state, sigp_from_params, track_scan, track_scan_plain)

    sig = get_signal(name)
    fs = 4.096e6
    prns, dops, phases = sig.prns()[:2], [900.0, -2200.0], [0.01, 417.25]
    n = int(fs * 0.07)
    x = sum(synth_iq_t(sig.code_table((p,))[0], sig.chip_rate, fs, n, d, c,
                       sig.subcarrier, sig.carrier_ratio, device=dev)
            for p, d, c in zip(prns, dops, phases))
    params = make_params(sig, fs, 0.0, loop_dwells=(8, 8))._replace(
        fused_scan=False, pallas_v2=not v1)
    xd = torch.cat([x, torch.zeros(params.nmax + 1024, dtype=x.dtype,
                                   device=dev)])
    tab = torch.from_numpy(sig.code_table(tuple(prns)).astype(np.int8)
                           ).to(dev)
    extra = (torch.full((2,), sig.carrier_ratio, device=dev),
             torch.zeros(2, dtype=torch.int32, device=dev),
             sigp_from_params(params, 2, dev))
    st = init_state(phases, [0.0] * 2, [0.0] * 2, dops, device=dev)
    for chunk_len, nb in ((int(fs * 0.03), 60), (n, 30)):
        n0 = track_step.LAUNCHES_V1 if v1 else track_step.LAUNCHES_V2
        k = track_scan(xd, chunk_len, tab, st, params, nb)
        assert (track_step.LAUNCHES_V1 if v1 else track_step.LAUNCHES_V2
                ) > n0
        cl = torch.full((2,), chunk_len, dtype=torch.int32, device=dev)
        p = track_scan_plain(xd, cl, tab, st, params, nb, *extra)
        torch.testing.assert_close(k[2], p[2], rtol=0, atol=0)
        torch.testing.assert_close(k[1], p[1], rtol=2e-5, atol=2e-4,
                                   equal_nan=True)
        st = k[0]._replace(stalled=torch.zeros_like(k[0].stalled))


def test_sharded_step_scan_on_the_card(dev):
    """track_scan_sharded on the per-step route (K3, params that do not
    take K2) over a 2 x 1 mesh of the card: one K3 launch a block for
    each shard, rows and state equal to the unsharded scan's bit for
    bit."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import track_step
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh
    from gnss_dsp_tpu_torch.parallel.track import track_scan_sharded
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import init_state, track_scan

    sig = get_signal("gps-l1")
    fs, nb = 4.096e6, 30
    prns, dops = sig.prns()[:4], [900.0, -2200.0, 150.0, 3100.0]
    phases = [0.01, 417.25, 800.5, 3.75]
    n = int(fs * 0.04)
    x = sum(synth_iq_t(sig.code_table((p,))[0], sig.chip_rate, fs, n, d, c,
                       sig.subcarrier, sig.carrier_ratio, device=dev)
            for p, d, c in zip(prns, dops, phases))
    params = make_params(sig, fs, 0.0, loop_dwells=(8, 8))._replace(
        fused_scan=False)
    xd = torch.cat([x, torch.zeros(params.nmax, dtype=x.dtype, device=dev)])
    tab = torch.from_numpy(sig.code_table(tuple(prns)).astype(np.int8)
                           ).to(dev)
    st = init_state(phases, [0.0] * 4, [0.0] * 4, dops, device=dev)
    want = track_scan(xd, n, tab, st, params, nb)
    n0 = track_step.LAUNCHES_V2
    got = track_scan_sharded(make_mesh(2, 1, devices=[dev] * 2), xd, n,
                             tab, st, params, nb)
    assert track_step.LAUNCHES_V2 == n0 + 2 * nb
    assert (got[2][:, :, 0] > 0).all()
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[1].nan_to_num(7.0), want[1].nan_to_num(7.0))
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)


def _glonass_l1(dev, fs, ms, live):
    """GLONASS L1 at fs (the band offset in the carrier, the code rate on
    the true doppler), channels live = {chan: (doppler, chips)}, on dev."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t

    sig = get_signal("glonass-l1")
    n = int(fs * ms / 1000)
    return sum(synth_iq_t(sig.code_table((c,))[0], sig.chip_rate, fs, n,
                          d + sig.fdma_hz * c, cp, "none",
                          sig.track_carrier_ratio(c), code_doppler_hz=d,
                          device=dev)
               for c, (d, cp) in live.items())


@pytest.mark.parametrize("dop_chunk", [None, 3])
def test_k1_one_code_row_grouped_by_channel(dev, dop_chunk):
    """The FDMA search at GLONASS L1's 16384 window: K1 with P = 1 over the
    5 channels' 8-doppler bands in chunks that do not follow the bands,
    each band reduced to its first maximum; the same cells as the search
    on the CPU (K1's plain version), metric rtol 1e-4."""
    from gnss_dsp_tpu_torch.acquire import engine
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import acquire2

    sig = get_signal("glonass-l1")
    live = {-2: (750.0, 300.25), 1: (-250.0, 41.5)}
    x = _glonass_l1(dev, sig.acq_fs, 7, live)
    chans, grid, ms = [-2, -1, 0, 1, 2], (-1000.0, 1000.0, 250.0), 4
    n = int(sig.acq_fs * 1e-3)
    dops, fixed = engine.fdma_grid(sig, grid, chans)
    cf = engine.device_code_ffts(sig, [0], n, n, dev)
    n0 = acquire2.LAUNCHES
    got = engine.grid_search(x, cf, torch.from_numpy(fixed), n=n, window=n,
                             blocks=ms, peak_mean=False, dop_chunk=dop_chunk,
                             group=8)
    assert acquire2.LAUNCHES == n0 + (1 if dop_chunk is None else 14)
    want = engine.grid_search(x.cpu(), cf.cpu(), torch.from_numpy(fixed),
                              n=n, window=n, blocks=ms, peak_mean=False,
                              dop_chunk=dop_chunk, group=8)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=0)
    res = engine.acquire_signal_fdma(sig, x, chans, grid, ms=ms)
    for r in res:
        if r.prn in live:
            assert r.doppler == live[r.prn][0]
            assert abs(r.code_offset - live[r.prn][1]) <= 1.0


def test_fdma_sharded_on_the_card(dev):
    """acquire_signal_fdma_sharded on a 2 x 2 mesh of the card (K1's
    surface, one code row a shard): the single-card search's cells,
    metric rtol 1e-5."""
    from gnss_dsp_tpu_torch.acquire import engine
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import acquire2
    from gnss_dsp_tpu_torch.parallel.acquire import (
        acquire_signal_fdma_sharded)
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    sig = get_signal("glonass-l1")
    x = _glonass_l1(dev, sig.acq_fs, 7, {0: (500.0, 99.0)})
    chans, grid = [-1, 0, 1], (-1000.0, 1000.0, 250.0)
    one = engine.acquire_signal_fdma(sig, x, chans, grid, ms=4)
    n0 = acquire2.LAUNCHES_SURFACE
    got = acquire_signal_fdma_sharded(sig, x, chans,
                                      make_mesh(devices=[dev] * 4), grid,
                                      ms=4)
    assert acquire2.LAUNCHES_SURFACE > n0
    for a, b in zip(one, got):
        assert (a.prn, a.doppler, a.code_offset) == \
            (b.prn, b.doppler, b.code_offset)
        assert abs(a.metric - b.metric) <= 1e-5 * a.metric
    assert (got[1].doppler, round(got[1].code_offset)) == (500.0, 99)


@pytest.mark.parametrize("name,prn,fs,ms,k_true,pp,dop,chan", [
    ("gps-l2cl", 5, 2.048e6, 40, 31, 1234.0, 250.0, 0),
    ("glonass-l1-p", 2, 4.096e6, 12, 417, 33.0, -700.0, 2)])
def test_serial_search_on_the_card(dev, name, prn, fs, ms, k_true, pp, dop,
                                   chan):
    """serial_search on the card against its CPU run on the same samples:
    k and code_offset exact, q within rtol 1e-6 (float64 sums on both,
    rounded to float32 once), and the sharded twin on a 2 x 2 mesh of the
    card bit-equal to the single-card search."""
    from gnss_dsp_tpu_torch.acquire import serial
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.parallel.acquire import serial_search_sharded
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t

    sig = get_signal(name)
    phase = (k_true * sig.acq_serial_stride + sig.acq_serial_scale * pp) \
        % sig.code_length
    x = synth_iq_t(sig.code_table((prn,))[0], sig.chip_rate, fs,
                   int(fs * (ms + 4) / 1000), dop + sig.fdma_hz * chan,
                   phase, "none", sig.track_carrier_ratio(chan),
                   code_doppler_hz=dop, device=dev)
    kw = dict(parent_code_phase=pp, fs=fs, ms=ms, chan=chan)
    got = serial.serial_search(sig, x, prn, dop, **kw)
    want = serial.serial_search(sig, x.cpu(), prn, dop, **kw)
    assert got.k == want.k == k_true
    assert got.code_offset == want.code_offset
    assert abs(got.metric - want.metric) <= 1e-6 * want.metric
    g = serial.hypothesis_geometry(sig, fs, ms, pp)
    q = [serial.chunked_q(serial.wipe_blocks(sig, xx, dop, fs, chan, g),
                          serial.device_code(sig, prn, xx.device), g.s_int,
                          g.s_frac, g, 64).cpu() for xx in (x, x.cpu())]
    torch.testing.assert_close(q[0], q[1], rtol=1e-6, atol=0)
    sh = serial_search_sharded(sig, x, prn, dop, mesh=make_mesh(
        devices=[dev] * 4), **kw)
    assert (sh.k, sh.metric) == (got.k, got.metric)


# mixed-signal launches (track multi, the receiver): each channel's own
# sigp row and code row in the [C, Lmax] table, the launch's kind the
# mix's: (name, [(signal, prn, doppler, code phase, carrier offset)], fs)
_K2_MIXES = [
    ("tmboc", [("gps-l1cp", 3, 700.0, 5100.4, 900.0),
               ("gps-l1", 7, 900.0, 317.25, 900.0),
               ("galileo-e1b", 24, -1500.0, 2047.3, 900.0),
               ("glonass-l1", -3, -700.0, 41.5, 900.0)], 4.096e6),
    ("subc", [("gps-l2cm", 29, 1120.0, 4208.8, 0.0),
              ("gps-l1", 7, 900.0, 317.25, 0.0),
              ("beidou-b1i", 34, 400.0, 1500.6, -150.0)], 4.096e6),
    ("long_code", [("gps-l2cl", 7, 900.0, 767200.5, 0.0),
                   ("gps-l1", 21, -1200.0, 317.25, 0.0)], 2.048e6),
]


@pytest.mark.parametrize("cluster", [1, 4, None])
@pytest.mark.parametrize("case", range(len(_K2_MIXES)))
def test_k2_mixed_kinds_match_plain_bit_for_bit(dev, case, cluster):
    """K2 with channels of different signals (subcarrier kinds, code
    lengths, FDMA, carrier offsets) in one launch against its plain
    version, across a stall and a refill (the long-code mix reads every
    row from device memory)."""
    from gnss_dsp_tpu_torch.tools.track_all import mixed_inputs

    kind, mix, fs = _K2_MIXES[case]
    d = mixed_inputs(mix, fs, 0.08, 9, dev)
    p = d["params"]
    assert p.fused_scan and p.subcarrier == ("subc" if kind == "long_code"
                                             else kind)
    extra = (d["ratios"], d["cdf"], d["sigp"], d["overlay"])
    C = len(mix)
    st = d["st"]
    for cl, nb in ((torch.full((C,), int(fs * 0.045), dtype=torch.int32,
                               device=dev), 60),
                   (torch.full((C,), d["n"], dtype=torch.int32,
                               device=dev), 60)):
        k = _k2_both(dev, d["x"], d["tab"], st, p, cl, nb, extra, cluster)
        assert bool(k[0].stalled.all())
        st = k[0]._replace(stalled=torch.zeros_like(k[0].stalled))


def test_k2_at_the_receiver_shape_runs_two_batches(dev):
    """The 2017 sky's 11 channels at 69.984 MHz in one launch: nmax
    104980, 8 CTAs a channel, the window staged in two batches; 40
    blocks against the plain version bit for bit."""
    from gnss_dsp_tpu_torch.ops import track_fused
    from gnss_dsp_tpu_torch.tools.receiver_sky import BANDS, FS
    from gnss_dsp_tpu_torch.tools.track_all import mixed_inputs

    mix = [s for seeds in BANDS.values() for s in seeds]
    d = mixed_inputs(mix, FS, 0.045, 3, dev)
    p = d["params"]
    plan = track_fused.cluster_plan(11, p.nmax)
    assert p.nmax == 104980 and plan["cluster"] == 8
    assert plan["batches"] == 2
    extra = (d["ratios"], d["cdf"], d["sigp"], d["overlay"])
    k = _k2_both(dev, d["x"], d["tab"], d["st"], p, d["n"], 40, extra, None)
    assert bool((k[2][:, :, 0] > 0).sum(0).ge(30).all())


def test_receiver_scans_match_plain_on_its_own_inputs(dev, tmp_path):
    """track_receiver over the 2017 sky's three bands (80 ms each at
    69.984 MHz, chunk_ms 20): each of its scans (band segments, each
    channel's segment end as its chunk_len, pointers inside its band's
    segment, the rebase between chunks) against the plain version on the
    same arguments bit for bit, one K2 launch a chunk."""
    from gnss_dsp_tpu_torch.ops import track_fused
    from gnss_dsp_tpu_torch.tools.receiver_sky import (
        BANDS, run_receiver, scans_held_to_plain, synth_bands)

    paths = {b: str(tmp_path / f"band{b}.iq") for b in BANDS}
    synth_bands(paths, 0.08, device=dev)
    n0 = track_fused.LAUNCHES
    stats = {}
    with scans_held_to_plain() as held:
        rows, _ = run_receiver(paths, dev, 20.0, stats=stats, max_blocks=48)
    assert held == [22, 22, 4] and stats["chunks"] == 3
    assert track_fused.LAUNCHES == n0 + 3
    assert all(len(r) >= 30 for r in rows.values())


def test_code_recovery_bins_lie_on_the_card(dev):
    """CodeRecovery given the card's blocks keeps its bins there."""
    from gnss_dsp_tpu_torch.track.recover import CodeRecovery

    rec = CodeRecovery(1023, warmup_blocks=0)
    x = torch.ones(4096, dtype=torch.complex64, device=dev)
    rec.update(x, 0.0, 0.25, 1.0)
    assert rec.acc_re.device.type == "cuda"
    assert rec.chips().shape == (1023,)


def test_int4_unpack_on_the_card(dev):
    """from_int4_iq on the card: the CPU's values, bit for bit."""
    from gnss_dsp_tpu_torch.ops import cplx

    rng = np.random.default_rng(8)
    raw = rng.integers(-128, 128, 20000, dtype=np.int16).astype(np.int8)
    packed = cplx.pack_int4_host(raw)
    a = cplx.from_int4_iq(packed, pad=33, device=dev)
    assert a.device.type == "cuda"
    assert torch.equal(a.cpu(), cplx.from_int4_iq(packed, pad=33))


def test_recovery_bins_are_bit_equal_run_to_run(dev):
    """Recovery on the card (the plain scan on CUDA tensors, no kernel):
    two runs give equal bits, equal to the CPU's within rtol 1e-5 of the
    largest bin."""
    import io

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import track_fused, track_step
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t
    from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file
    from gnss_dsp_tpu_torch.utils.synth import to_int8_iq

    sig = get_signal("beidou-b2bi")
    fs = 22.0e6
    bits = np.random.default_rng(1).choice([-1.0, 1.0], 50)
    x = synth_iq_t(sig.code_table((19,))[0], sig.chip_rate, fs,
                   int(fs * 0.04), 800.0, 0.0, "none", sig.carrier_ratio,
                   device="cpu", data_bits=bits).numpy()
    x = x + np.random.default_rng(2).standard_normal(x.size) * 3
    raw = to_int8_iq(x, scale=8.0)

    def run(device):
        ch = TrackChannel(prn=19, doppler=800.0, code_offset=0.0)
        track_file(sig, io.BytesIO(raw), fs, 0.0, [ch], loop_dwells=(10, 10),
                   recover_after=10, device=device)
        return ch.recovered

    n0 = (track_fused.LAUNCHES, track_step.LAUNCHES_V2)
    a, b = run(dev), run(dev)
    assert (track_fused.LAUNCHES, track_step.LAUNCHES_V2) == n0
    np.testing.assert_array_equal(a, b)
    c = run("cpu")
    np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5 * np.abs(c).max())


def test_k3_mixed_code_lengths_match_plain(dev):
    """K3 with each channel's own code length (lens) in a wider table,
    against the plain version to one float32 ulp of the largest sum."""
    from gnss_dsp_tpu_torch.ops import track_step

    C, nmax = 3, 6200
    si, sf, x, code = _step_inputs(dev, C, 10230, 6000, nmax,
                                   (1.0, 0.0, 0.0, 0.0), 12)
    lens = torch.tensor([1023, 10230, 2046], dtype=torch.int32, device=dev)
    si[:, :3] = torch.remainder(si[:, :3], lens[:, None])
    got = track_step.epl_correlate2(si, sf, x, code, nmax, "none", lens)
    want = track_step.epl_correlate_plain(si, sf, x, code, nmax, "none",
                                          lens=lens)
    _check_step(got, want)
    full = track_step.epl_correlate_plain(si, sf, x, code, nmax, "none")
    assert not torch.equal(full, want)


def test_squaring_and_probe_on_the_card(dev):
    """ops/squaring and track/probe.correlation_shape on card tensors
    stay there and give their CPU results: squaring rtol 1e-5 (atol 1e-5
    n m max|x|^2), the probe rtol 1e-5 (atol 1e-6 n) for every
    subcarrier kind."""
    from gnss_dsp_tpu_torch.ops.squaring import squaring
    from gnss_dsp_tpu_torch.track.probe import correlation_shape

    g = torch.Generator().manual_seed(5)
    x = torch.complex(torch.randn(3 * 16 * 100 + 9, generator=g),
                      torch.randn(3 * 16 * 100 + 9, generator=g))
    r = squaring(x.to(dev), 16, 100)
    assert r.device.type == "cuda"
    atol = 1e-5 * 1600 * float(x.abs().max()) ** 2
    torch.testing.assert_close(r.cpu(), squaring(x, 16, 100), rtol=1e-5,
                               atol=atol)
    code = torch.from_numpy(np.where(np.random.default_rng(1).random(4092)
                                     < 0.5, -1, 1).astype(np.int8))
    n = 8000
    for kind in ("none", "boc11", "cboc", "tmboc"):
        c = correlation_shape(x[:n].to(dev), code.to(dev), 4090.3, 0.125,
                              0.0125, 320, 4092, kind)
        assert c.device.type == "cuda" and c.shape == (320,)
        torch.testing.assert_close(
            c.cpu(), correlation_shape(x[:n], code, 4090.3, 0.125, 0.0125,
                                       320, 4092, kind),
            rtol=1e-5, atol=1e-6 * n)


def test_preloaded_whole_band_chunk_matches_plain(dev, tmp_path):
    """A 0.25 s GPS L1 band at 69.984 MHz preloaded whole on the card
    (cli/track._preload_chunk, one K2 launch over the whole chunk): that
    scan against the plain version on the same arguments bit for bit,
    and the rows equal to the streaming run's."""
    from gnss_dsp_tpu_torch.cli.track import _preload_chunk
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import track_fused
    from gnss_dsp_tpu_torch.tools.receiver_sky import FS, synth_bands
    from gnss_dsp_tpu_torch.track import driver, engine
    from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file

    seed = ("gps-l1", 21, 2400.0, 817.50, -9334875.0)
    path = str(tmp_path / "band1.iq")
    synth_bands({1: path}, 0.25, bands={1: [seed]}, device=dev)
    x, n = _preload_chunk(path, FS, 2000.0, {}, device=dev)
    assert x.device.type == "cuda" and n == int(FS * 0.25)

    def run(preloaded):
        ch = [TrackChannel(prn=21, doppler=2400.0, code_offset=817.5)]
        with open(path, "rb") as fp:
            track_file(get_signal("gps-l1"), fp, FS, seed[4], ch, device=dev,
                       preloaded=preloaded)
        return ch[0].rows

    scan = driver.track_scan
    held = []

    def both(x, chunk_len, code_tab, state, params, n_blocks, **kw):
        k = scan(x, chunk_len, code_tab, state, params, n_blocks, **kw)
        p = engine.track_scan_plain(x, chunk_len, code_tab, state, params,
                                    n_blocks, **kw)
        torch.testing.assert_close(k[2], p[2], rtol=0, atol=0)
        torch.testing.assert_close(k[1], p[1], rtol=0, atol=0,
                                   equal_nan=True)
        for a, b in zip(k[0], p[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        held.append((x.shape[0], n_blocks))
        return k

    n0 = track_fused.LAUNCHES
    driver.track_scan = both
    try:
        rows = run((x, n))
    finally:
        driver.track_scan = scan
    assert held == [(x.shape[0], int(n / FS * 1000.0) + 2)]
    assert track_fused.LAUNCHES == n0 + 1 and len(rows) >= 240
    assert rows == run(None)


def test_k7_at_61380_on_the_single_card_route(dev, monkeypatch, tmp_path):
    """GNSS_DSP_NO_V2P: GPS L5I's single-card search takes K7 at its 2n
    window 61380 (acquire/plan "v1"), K1 not at all; the planted PRNs win
    the cells the padded v2p route gives."""
    from gnss_dsp_tpu_torch.acquire.engine import acquire_signal
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import acquire, acquire2
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t

    sig = get_signal("gps-l5i")
    fs, ms = sig.acq_fs, 6
    n = int(fs * (ms + 4) / 1000)
    x = sum(synth_iq_t(sig.code_table((p,))[0], sig.chip_rate, fs, n, d, c,
                       "none", sig.carrier_ratio, device=dev)
            for p, d, c in ((25, 1000.0, 5000.25), (7, -2000.0, 88.0)))
    grid = (-3000.0, 3000.0, 1000.0)
    padded = acquire_signal(sig, x, [25, 7, 3], grid, ms=ms)
    monkeypatch.setenv("GNSS_DSP_NO_V2P", "1")
    n1, n7 = acquire2.LAUNCHES, acquire.LAUNCHES
    got = acquire_signal(sig, x, [25, 7, 3], grid, ms=ms)
    assert acquire2.LAUNCHES == n1 and acquire.LAUNCHES > n7
    for a, b in zip(got[:2], padded[:2]):
        # the same lag, indexed among v1's 2n lags or v2p's last n of its
        # padded window: the offsets (mod the code length) may differ in
        # float64's last bits
        assert (a.prn, a.doppler) == (b.prn, b.doppler)
        assert abs(a.code_offset - b.code_offset) < 1e-6
    assert got[2].metric < min(got[0].metric, got[1].metric)


def _ingest_capture(seconds, seed=29):
    """GPS L1 at 4.096 MHz, two PRNs at 45 dB-Hz, int8 I/Q bytes."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.utils.synth import synth_iq, to_int8_iq

    sig = get_signal("gps-l1")
    fs = 4.096e6
    n = int(fs * seconds)
    rng = np.random.default_rng(seed)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in ((7, 900.0, 317.25), (13, -2200.0, 5.0)):
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                      doppler_hz=dop, code_phase=cp, cn0_dbhz=45.0,
                      carrier_ratio=sig.carrier_ratio, rng=rng)
    return to_int8_iq(x, scale=16.0), fs


def _rows(chans):
    return [np.array([list(r.values()) for r in ch.rows], np.float64)
            for ch in chans]


def _chunks_seen(monkeypatch, module):
    """Every chunk `module`.track_scan is handed, as (samples on the CPU,
    chunk_len on the CPU)."""
    import torch

    seen = []
    scan = module.track_scan

    def spy(x, chunk_len, *a, **k):
        seen.append((x.cpu().clone(), torch.as_tensor(chunk_len).cpu()))
        return scan(x, chunk_len, *a, **k)
    monkeypatch.setattr(module, "track_scan", spy)
    return seen


def _same_chunks(a, b):
    assert len(a) == len(b) >= 2
    for (xa, na), (xb, nb) in zip(a, b):
        assert xa.shape == xb.shape and torch.equal(na, nb)
        assert torch.equal(torch.view_as_real(xa), torch.view_as_real(xb))


def _stream(data, fs, device, preloaded=None):
    import io

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file

    chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
             for p, d, cp in ((7, 900.0, 317.25), (13, -2200.0, 5.0))]
    track_file(get_signal("gps-l1"), io.BytesIO(data), fs, 0.0, chans,
               loop_dwells=(8, 8), chunk_ms=10.0, device=device,
               preloaded=preloaded)
    return _rows(chans)


@pytest.mark.parametrize("int4", [False, True])
def test_streaming_track_file_on_the_card_builds_the_cpus_chunks(
        dev, int4, monkeypatch):
    """track_file streaming 10 ms chunks over 95 ms on the card: nine
    chunks or more, so each of a reader's three pinned slots is read
    into three times, every read gated on the upload from it.  Every
    chunk the scan is handed (the carried samples, the new bytes, the
    pad) is the CPU run's, bit for bit, with int8 and 4-bit uploads; the
    rows are those of the scan over the whole capture in one chunk on
    the card (the preloaded path).  (The rows are not compared with the
    CPU's: the plain scan there rounds its trigonometry otherwise.)"""
    from gnss_dsp_tpu_torch.ops import cplx
    from gnss_dsp_tpu_torch.track import driver

    if int4:
        monkeypatch.setenv("GNSS_DSP_UPLOAD_INT4", "1")
    else:
        monkeypatch.delenv("GNSS_DSP_UPLOAD_INT4", raising=False)
    data, fs = _ingest_capture(0.095)
    raw = np.frombuffer(data, np.int8)
    n = len(raw) // 2
    pad = int(fs * 0.006) + 16384
    pad += (-(n + pad)) % 1024
    x = (cplx.from_int4_iq(cplx.pack_int4_host(raw), pad=pad, device=dev)
         if int4 else cplx.from_int8_iq(raw, pad=pad, device=dev))
    whole = _stream(b"", fs, dev, preloaded=(x, n))
    calls = []
    from_iq = cplx.from_iq

    def spy(*a, **k):
        calls.append(k["into"].device.type)
        return from_iq(*a, **k)
    monkeypatch.setattr(cplx, "from_iq", spy)
    seen = _chunks_seen(monkeypatch, driver)
    card = _stream(data, fs, dev)
    on_card = list(seen)
    seen.clear()
    _stream(data, fs, "cpu")
    _same_chunks(on_card, seen)
    for a, b in zip(card, whole):
        assert len(a) >= 90
        np.testing.assert_array_equal(a, b)
    assert calls.count("cuda") >= 9


def test_second_streaming_call_allocates_no_pinned_memory(dev, tmp_path,
                                                          monkeypatch):
    """A second streaming call in the process pins nothing new: torch's
    caching host allocator hands it the blocks the first call's slots
    let go of (track.pinned.alloc 0), and every byte goes up from pinned
    memory (h2d.pinned_bytes == h2d.bytes)."""
    from gnss_dsp_tpu_torch.utils import profiling

    monkeypatch.delenv("GNSS_DSP_UPLOAD_INT4", raising=False)
    data, fs = _ingest_capture(0.045, seed=31)
    with profiling.trace(str(tmp_path / "t")):
        first = _stream(data, fs, dev)
        profiling.reset()
        again = _stream(data, fs, dev)
        c = profiling.counts()
    assert c["track.pinned.alloc"] == 0
    assert c["h2d.pinned_bytes"] == c["h2d.bytes"] == len(data)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_streaming_receiver_on_the_card_builds_the_cpus_chunks(
        dev, monkeypatch):
    """track_receiver over two bands (45 and 30 ms) in 10 ms chunks on
    the card, the segments built there: every segmented chunk is the CPU
    run's, bit for bit, and the rows are those of one chunk over the
    whole captures on the card."""
    import io

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.track import receiver
    from gnss_dsp_tpu_torch.track.driver import TrackChannel

    monkeypatch.delenv("GNSS_DSP_UPLOAD_INT4", raising=False)
    a, fs = _ingest_capture(0.045, seed=37)
    b, _fs = _ingest_capture(0.030, seed=41)

    def run(device, chunk_ms=10.0):
        bands = [(io.BytesIO(d), [get_signal("gps-l1")] * 2,
                  [TrackChannel(prn=p, doppler=dp, code_offset=cp)
                   for p, dp, cp in ((7, 900.0, 317.25),
                                     (13, -2200.0, 5.0))], [0.0, 0.0])
                 for d in (a, b)]
        return _rows(receiver.track_receiver(
            bands, fs, loop_dwells=(8, 8), chunk_ms=chunk_ms,
            device=device))
    whole = run(dev, chunk_ms=100.0)
    seen = _chunks_seen(monkeypatch, receiver)
    card = run(dev)
    on_card = list(seen)
    seen.clear()
    run("cpu")
    assert len(on_card) >= 4
    _same_chunks(on_card, seen)
    for x, y in zip(card, whole):
        assert len(x) >= 25
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["one-channel", "channels",
                                  "multi-9-and-14", "clones-and-short-nb",
                                  "all-idle", "past-the-bound"])
def test_rows_text_kernel_matches_rows(dev, case):
    """csrc/track_rows.cu on seed-drawn rows (tests/test_torch_track_rows:
    %f ties, -0.0, tiny negatives, NaN of both signs, +-inf, the largest
    float32 below the bound, clones, nb short of the rows, samp past
    2^31): head and text bytes equal to the row-by-row path's
    (rows_text_by_row, format_row_14/9 a row, and emit_rows with a plain
    emit); a field past the bound flags the scan on both."""
    from test_torch_track_rows import CASES, _channels, _counters, \
        row_by_row, rows_text_by_row, scan_rows

    from gnss_dsp_tpu_torch.ops import track_rows

    seed, B, nb, C, n_emit, prefixes, formats = CASES[
        "channels" if case == "past-the-bound" else case]
    rf, ri = scan_rows(seed, B, C,
                       zero_share=1.0 if case == "all-idle" else 0.2)
    if case == "past-the-bound":
        rf[3, 2, 5] = float(np.float32(track_rows.FIXED_MAX))
    pre = torch.tensor(list("".join(prefixes).encode()), dtype=torch.uint8)
    off = torch.tensor(np.cumsum([0] + [len(p) for p in prefixes]),
                       dtype=torch.int32)
    wide = torch.tensor([f == 14 for f in formats], dtype=torch.int32)
    c0 = torch.tensor(_counters(_channels(C, seed)[:n_emit]),
                      dtype=torch.int64).reshape(n_emit, 3)
    args = (nb, n_emit, pre, off, wide, c0)
    n0 = track_rows.LAUNCHES
    hk, tk = track_rows.rows_text(rf.to(dev), ri.to(dev), nb, n_emit,
                                  *(t.to(dev) for t in args[2:]))
    torch.cuda.synchronize(dev)
    assert track_rows.LAUNCHES == n0 + 1
    hp, tp = rows_text_by_row(rf, ri, *args)
    hk = hk.cpu().numpy()
    np.testing.assert_array_equal(hk, hp.numpy())
    if case == "past-the-bound":
        assert hk[3] == 1
        return
    text = bytes(tk[:int(hk[0])].cpu().numpy())
    assert text == bytes(tp.numpy())
    want, ref_ch, ref_any = row_by_row(rf, ri, nb, n_emit, prefixes,
                                       formats, seed)
    assert text == want.encode() and bool(hk[2]) == ref_any
    assert hk[4:].reshape(n_emit, 3).tolist() == \
        [list(c) for c in _counters(ref_ch[:n_emit])]


def test_rows_text_on_a_gps_l1_scan(dev):
    """One K2 scan of 6 GPS L1 channels: emit_rows with a RowText on the
    card writes the bytes of the row-by-row path, as a RowText on the CPU
    (a row at a time) does, and leaves the same counters."""
    import contextlib
    import io

    from gnss_dsp_tpu_torch.ops import track_rows
    from gnss_dsp_tpu_torch.tools.track_all import scan_inputs
    from gnss_dsp_tpu_torch.track import driver
    from gnss_dsp_tpu_torch.track.engine import track_scan
    from gnss_dsp_tpu_torch.track.rows import RowText, format_row_14

    C, fs = 6, 4.096e6
    d = scan_inputs("gps-l1", C, fs, 0.08, 5, dev)
    _st, rf, ri = track_scan(d["x"], d["n"], d["tab"], d["st"], d["params"],
                             70, ratios=d["ratios"], coffset_df=d["cdf"],
                             sigp=d["sigp"], overlay=d["overlay"])
    assert rf.device.type == "cuda"
    prefixes = [f"ch{k} " for k in range(C)]

    def channels():
        return [driver.TrackChannel(prn=k, doppler=0.0, code_offset=0.0,
                                    samp=3_000_000_000 + k) for k in range(C)]
    ref, out = channels(), []
    want_any = driver.emit_rows(
        ref, C, lambda k, row: out.append(prefixes[k] + format_row_14(row)
                                          + "\n"), rf, ri, 70)
    texts = {}
    for where in ("cuda", "cpu"):
        chans, buf = channels(), io.StringIO()
        n0 = track_rows.LAUNCHES
        with contextlib.redirect_stdout(buf):
            got_any = driver.emit_rows(
                chans, C, RowText(prefixes, [14] * C,
                                  dev if where == "cuda" else "cpu"),
                rf, ri, 70)
        assert track_rows.LAUNCHES == n0 + (where == "cuda")
        assert got_any == want_any
        assert [(c.samp, c.code_cyc, c.carrier_cyc) for c in chans] == \
            [(c.samp, c.code_cyc, c.carrier_cyc) for c in ref]
        texts[where] = buf.getvalue()
    assert texts["cuda"] == texts["cpu"] == "".join(out)
    assert len(out) >= 6 * 60
