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
bit-equal to one cluster walking every alignment); K3
and K4 equal to their plain version to one float32 ulp of the channel's
largest sum (both sum exact float64 products and round once; a sum within
2^-29 of a rounding tie may round the other way), two launches bit-equal,
and bit-equal to the host emulation of their order of summation
(tests/test_torch_track_step_plan.step_sums); a K3 launch replayed from a
CUDA graph bit-equal to an eager one.
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
    rtol 1e-4), and the same at 4 CTAs a cluster."""
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
