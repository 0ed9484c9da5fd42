"""K6's two stages (gnss_dsp_tpu_torch/ops/acquire_coh.py, kernel
csrc/acquire_coh.cu) on the CPU.

  * the combine, then K5's surface: corr_surface_coh_spec_plain(
    combine_blk_plain(F, ...), code_f, A, n_valid) against K6's plain
    version corr_surface_coh_plain (the per-block surfaces rotated and
    summed after their IDFT) at A = 1, 4 and 100 alignments, n_valid 0
    and set, a planted cell in every (PRN, doppler): idx and align equal,
    peak rtol 1e-5 (float32 sums in another order);
  * both against pallas_acquire_coh.corr_surface_coh in interpret mode
    on the same bf16-rounded spectra, as test_torch_acquire_coh.py's
    test_k6_plain_matches_pallas_kernel_interpret runs it, at A = 1 and 4
    on the circular and padded windows and at A = 100 on the circular one
    (the interpret-mode kernel unrolls its alignments: ~40 s there): idx
    and align equal, peak within 3e-2 of the largest (the TPU kernel's
    bf16 IDFT);
  * a numpy model of the surface stage's 64-bit merge key
    (csrc/acq_cluster.cuh merge_chunk: the peak's float bits above
    (16383 - lag) << 16 | (65535 - a)) gives finalize_max's winner on
    planted exact ties in lag and in alignment across alignment chunks,
    in any merge order;
  * blk_plan splits the alignments where the clusters would not fill
    the card (Xona X1P: 1 PRN x 70 dopplers, A = 100) and keeps one
    cluster per (PRN, doppler) at GPS L1's --coherent 8 shape.
"""

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.ops import acquire_coh
from test_torch_acquire_coh import _bf16_split, _natural


def _window(padded):
    """(W, n1, n2, n_valid) of the TPU plan: the circular 2048 (lane-packed
    g = 8) or 2 x 1000 padded to its aligned length."""
    from gnss_dsp_tpu.ops import pallas_acquire2 as pa2

    if padded:
        n1, n2, W = pa2.plan_padded(2000)
        return W, n1, n2, 1000
    n1, n2 = pa2.plan_aligned(2048)
    return 2048, n1, n2, 0


def _inputs(A, W, n_valid, P=2, DC=2, m_coh=8, G=2, seed=0):
    """Unit-modulus code spectra, noise spectra F [DC, B, W], rotations and
    random overlay signs [A, B]; every (p, d) planted at a random
    alignment a and searched lag j: block m of F[d] carries sec[a, m]
    rot[d, m] code_f[p] e^{+2 pi i k j/W}, whose group sums peak at lag j
    of alignment a.  Returns numpy arrays and the plants (p, d, a, j - lo)."""
    rng = np.random.default_rng(seed + A + n_valid)
    B = G * m_coh
    code = np.exp(2j * np.pi * rng.random((P, W)))
    F = 0.3 * (rng.standard_normal((DC, B, W))
               + 1j * rng.standard_normal((DC, B, W)))
    sec_mat = rng.choice([-1.0, 1.0], (A, B))
    ang = rng.uniform(-np.pi, np.pi, (DC, B))
    rot = np.exp(1j * ang)
    lo = W - n_valid if n_valid else 0
    k = np.arange(W)
    plants = []
    for p in range(P):
        for d in range(DC):
            a, j = int(rng.integers(A)), lo + int(rng.integers(W - lo))
            amp = 0.4 + 0.1 * (p * DC + d)
            F[d] += (amp * sec_mat[a][:, None] * rot[d][:, None]
                     * (code[p] * np.exp(2j * np.pi * k * j / W))[None])
            plants.append((p, d, a, j - lo))
    return code, F, np.cos(ang), np.sin(ang), sec_mat, m_coh, plants


def _torch_args(code, F, cos, sin, sec_mat):
    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return (torch.from_numpy(F.astype(np.complex64)),
            torch.from_numpy(code.astype(np.complex64)), f32(cos), f32(sin),
            f32(sec_mat))


def _both(F, code, cos, sin, sec_mat, m_coh, n_valid):
    """(K6's plain version, the combine then K5's plain version)."""
    A = sec_mat.shape[0]
    k6 = acquire_coh.corr_surface_coh_plain(F, code, cos, sin, sec_mat, m_coh,
                                            n_valid)
    f2 = acquire_coh.combine_blk_plain(F, cos, sin, sec_mat, m_coh)
    assert f2.shape == (F.shape[0], F.shape[1] // m_coh * A, F.shape[2])
    return k6, acquire_coh.corr_surface_coh_spec_plain(f2, code, A, n_valid)


def _check_plants(got, plants):
    for p, d, a, j in plants:
        assert (int(got[1][p, d]), int(got[2][p, d])) == (j, a), (p, d)


@pytest.mark.parametrize("padded", [False, True], ids=["circular", "padded"])
@pytest.mark.parametrize("A", [1, 4, 100])
def test_combine_then_spec_is_k6_plain(A, padded):
    W, _, _, n_valid = _window(padded)
    code, F, cos, sin, sec_mat, m_coh, plants = _inputs(A, W, n_valid)
    k6, blk = _both(*_torch_args(code, F, cos, sin, sec_mat), m_coh, n_valid)
    _check_plants(k6, plants)
    assert torch.equal(k6[1], blk[1]) and torch.equal(k6[2], blk[2])
    torch.testing.assert_close(blk[0], k6[0], rtol=1e-5, atol=0)
    assert all(v.dtype == torch.int32 for v in blk[1:])


@pytest.mark.parametrize("A,padded", [(1, False), (1, True), (4, False),
                                      (4, True), (100, False)],
                         ids=["A1-circular", "A1-padded", "A4-circular",
                              "A4-padded", "A100-circular"])
def test_k6_stages_match_pallas_kernel_interpret(A, padded):
    import jax.numpy as jnp

    from gnss_dsp_tpu.ops.pallas_acquire_coh import corr_surface_coh

    W, n1, n2, n_valid = _window(padded)
    code, F, cos, sin, sec_mat, m_coh, plants = _inputs(A, W, n_valid)
    F16, C16 = _bf16_split(F, n1, n2), _bf16_split(code, n1, n2)
    cos32, sin32 = cos.astype(np.float32), sin.astype(np.float32)
    want = corr_surface_coh(F16, C16, jnp.asarray(cos32), jnp.asarray(sin32),
                            jnp.asarray(sec_mat.astype(np.float32)), n1=n1,
                            n2=n2, bt=8, m_coh=m_coh, n_valid=n_valid,
                            interpret=True)
    pk_j, ix_j, al_j = (np.asarray(v) for v in want)
    args = (_natural(F16, n1, n2), _natural(C16, n1, n2),
            torch.from_numpy(cos32), torch.from_numpy(sin32),
            torch.from_numpy(sec_mat.astype(np.float32)))
    for got in _both(*args, m_coh, n_valid):
        _check_plants(got, plants)
        np.testing.assert_array_equal(got[1].numpy(), ix_j)
        np.testing.assert_array_equal(got[2].numpy(), al_j)
        np.testing.assert_allclose(got[0].numpy(), pk_j, rtol=0,
                                   atol=3e-2 * pk_j.max())


# ------------------------------------------------- the alignment chunks' merge

def _key(peak, lag, a):
    """merge_chunk's key: the float bits of a non-negative peak above
    (16383 - lag) << 16 | (65535 - a), as uint64."""
    bits = np.array(peak, np.float32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | np.uint64((16383 - lag) << 16 |
                                               (65535 - a))


def _decode(key):
    peak = np.array(key >> np.uint64(32), np.uint32).view(np.float32)
    lag = int((key >> np.uint64(16)) & np.uint64(0xffff))
    return float(peak), 16383 - lag, 65535 - int(key & np.uint64(0xffff))


def _tied_surfaces(A, W, case):
    """q f32 [A, W] of small random values with one planted exact tie at
    the top: "lag" two lags of one alignment, "align" one lag of two
    alignments, "both" two lags of each of two alignments."""
    rng = np.random.default_rng(A * W)
    q = rng.random((A, W)).astype(np.float32)
    top = np.float32(3.0)
    a1, a2 = sorted(rng.choice(A, 2, replace=False).tolist())
    j1, j2 = sorted(rng.choice(W, 2, replace=False).tolist())
    if case == "lag":
        q[a2, [j1, j2]] = top
    elif case == "align":
        q[[a1, a2], j2] = top
    else:
        q[a1, [j1, j2]] = top
        q[a2, [j1, j2]] = top
    return q


@pytest.mark.parametrize("case", ["lag", "align", "both"])
@pytest.mark.parametrize("n_valid", [0, 200])
def test_merge_key_gives_finalize_max_winner(case, n_valid):
    """Each chunk of a_chunk alignments reports its own finalize_max
    winner (the cluster's reduction); the chunks' keys merged by max, in
    five random orders, decode to finalize_max over every alignment."""
    A, W = 7, 512
    q = torch.from_numpy(_tied_surfaces(A, W, case))
    want = [int(v) if v.dtype == torch.int32 else float(v)
            for v in (x[0, 0] for x in acquire_coh.finalize_max(
                q[None, None], n_valid))]
    rng = np.random.default_rng(len(case) + n_valid)
    for a_chunk in (1, 2, 3, A):
        keys = []
        for a0 in range(0, A, a_chunk):
            pk, ix, al = (x[0, 0] for x in acquire_coh.finalize_max(
                q[None, None, a0:a0 + a_chunk], n_valid))
            keys.append(_key(float(pk), int(ix), a0 + int(al)))
        for _ in range(5):
            order = rng.permutation(len(keys))
            merged = np.uint64(0)
            for i in order:
                merged = max(merged, keys[i])
            assert list(_decode(merged)) == want, (case, a_chunk, order)


def test_merge_key_orders_as_finalize_max():
    """Higher peak first, then the lower lag, then the lower alignment,
    over the whole range the kernel admits (lag < 16384, a < 65536)."""
    assert _key(1.5, 16383, 65535) > _key(1.25, 0, 0)
    assert _key(1.5, 0, 65535) > _key(1.5, 1, 0)
    assert _key(1.5, 7, 0) > _key(1.5, 7, 1)
    assert _key(0.0, 16383, 65535) == np.uint64(0)
    assert _decode(_key(2.75, 16383, 65535)) == (2.75, 16383, 65535)


# ----------------------------------------------------------------- the plan

def test_blk_plan_fills_the_card_at_x1p_and_keeps_gps_l1_whole():
    sms = 132
    # GPS L1 --coherent 8: 32 PRNs x 102 dopplers, G = 10, A = 1
    assert acquire_coh.blk_plan(32, 102, 1, 10, 4096, sms) == (2, 1)
    # Xona X1P --coherent 100: 1 PRN x 70 (and 40) dopplers, G = 2, A = 100
    for DC in (70, 40):
        C, a_chunk = acquire_coh.blk_plan(1, DC, 100, 2, 4096, sms)
        chunks = -(-100 // a_chunk)
        assert C == 2 and chunks > 1
        assert DC * chunks * C >= acquire_coh.FILL_CTAS * sms
        assert 2 * a_chunk >= acquire_coh.MIN_ROWS
    # K5's cluster sizes: K1's 2 at 4096, 8 at 16384, 1 at 2; past 16384
    # (K6's windows end there) refused
    assert acquire_coh.spec_core_plan(4096) == ("split", 64, 64, 2)
    assert acquire_coh.spec_core_plan(2048) == ("split", 32, 64, 8)
    assert acquire_coh.blk_plan(2, 3, 4, 2, 16384, sms)[0] == 8
    assert acquire_coh.blk_plan(2, 3, 4, 2, 2, sms)[0] == 1
    with pytest.raises(NotImplementedError):
        acquire_coh.blk_plan(1, 1, 1, 1, 32768, sms)
