"""Wide-window and odd-length acquisition in the port (gnss_dsp_tpu_torch)
against the JAX package, on the CPU.

  * the route (acquire/plan.acq_plan) against the JAX router's own
    functions (pallas_acquire2.plan_aligned, plan_padded,
    pallas_acquire.plan2, in _fused_plan's order) on every catalog signal;
  * kernel K7's plain version against pallas_acquire.corr_surface run in
    interpret mode at W = 30690, the TPU kernel's permuted lags put in
    natural order: within 2e-2 of the surface maximum (the TPU kernel's
    inverse DFT runs as bf16 matmuls), a planted shift exact;
  * kernel K1's plain version with n_valid against
    pallas_acquire2.corr_surface2(reduce=True, n_valid) in interpret mode
    at the padded-window case of tests/test_pallas.py: idx exact, peak to
    2e-2 of the scale, sum to rtol 3e-2 (bf16 again);
  * K1's plain version at a non-power-of-two W against numpy;
  * the four-step inverse DFT the wide kernels run on the card (mixed-
    radix Stockham passes over the host twiddle tables, w^(j1*k2) between
    them), emulated in numpy, against np.fft.ifft; the same for K7's
    cluster core (csrc/acq_cluster.cuh: which rank owns which columns and
    rows, the distributed-shared-memory transpose addresses, the
    two-table twiddle);
  * acquire_signal against the JAX one on small planted captures of one
    signal per route: planted PRNs with equal doppler and code offset and
    the metric to 2.4e-3 relative (the acquisition engine's bf16 budget),
    except where the reference's own surface ties at both cells to
    float32 rounding (the flat top of an RZ or BOC correlation); on the
    masked v2p route every absent PRN's peak at most the reference's (its
    lags are a subset of the reference's 2n circular lags), on the
    circular routes every PRN as the planted ones.
"""

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.acquire.plan import acq_plan
from gnss_dsp_tpu_torch.models.signal import all_signals, get_signal
from gnss_dsp_tpu_torch.ops import acquire, acquire2


@pytest.mark.parametrize("name", sorted(all_signals()))
def test_route_matches_jax_router(name):
    from gnss_dsp_tpu.models import get_signal as jget
    from gnss_dsp_tpu.ops import pallas_acquire as pa
    from gnss_dsp_tpu.ops import pallas_acquire2 as pa2

    sig = jget(name)
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    dw = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    want = None
    try:
        pa2.plan_aligned(dw)
        want = ("v2", dw, dw, 0)
    except ValueError:
        if sig.acq_pad2:
            try:
                want = ("v2p", pa2.plan_padded(dw)[2], dw, n)
            except ValueError:
                pass
        if want is None:
            pa.plan2(dw)          # the JAX package's v1 kernel plan exists
            want = ("v1", dw, dw, 0)
    got = acq_plan(get_signal(name))
    assert got == want
    route, window, _, n_valid = got
    if route == "v2p":            # padded to a power of two, exact lags n
        assert window & (window - 1) == 0 and window >= 2 * n_valid
    if not (sig.fdma_hz or sig.acq_serial) and window > acquire2.MAX_W:
        n1, n2 = acquire2.wide_split(window)
        assert n1 * n2 == window


def test_wide_split_of_the_catalog_windows():
    assert acquire2.wide_split(30690) == (165, 186)
    assert acquire2.wide_split(32768) == (128, 256)
    assert acquire2.wide_split(65536) == (256, 256)
    assert acquire2.wide_split(81920) == (256, 320)
    assert acquire2.wide_split(163840) == (320, 512)
    with pytest.raises(NotImplementedError):
        acquire2.wide_split(7 * 13 * 64)


def _four_step_ifft(X, W):
    """The four-step kernel's inverse DFT (csrc/acq_wide.cuh), step for
    step: the column pass of n1-point transforms over k1, the twiddle
    w^(j1*k2), the row pass of n2-point transforms, each a sequence of
    Stockham passes in next_radix order over wide_twiddle_table."""
    n1, n2 = acquire2.wide_split(W)
    tw = acquire2.wide_twiddle_table(n1, n2).astype(np.complex128)
    root = acquire2.root_table(W).astype(np.complex128)
    hdr = tw[:16 + sum(acquire2.WIDE_ROOTS)]
    roots = {}
    off = 16
    for r in acquire2.WIDE_ROOTS:
        roots[r] = hdr[off:off + r]
        off += r

    def sub(a, m, toff):
        nb = a.size // m
        ns, o = 1, toff
        while ns < m:
            R = acquire2.next_radix(m // ns)
            items = m // R
            u = np.arange(nb * items)
            t, j = u // items, u % items
            k = j % ns
            v = [a[t * m + j + r * items] * (tw[o + r * ns + k] if r else 1)
                 for r in range(R)]
            if R & (R - 1) == 0:     # radix-2 stages, roots of 16
                bits = R.bit_length() - 1
                v = [v[int(format(r, f"0{bits}b")[::-1], 2) if bits else 0]
                     for r in range(R)]
                ln = 2
                while ln <= R:
                    for i in range(0, R, ln):
                        for kk in range(ln // 2):
                            x0 = v[i + kk]
                            x1 = v[i + kk + ln // 2] * (
                                hdr[kk * (16 // ln)] if kk else 1)
                            v[i + kk], v[i + kk + ln // 2] = x0 + x1, x0 - x1
                    ln <<= 1
                y = v
            else:                    # direct DFT on the stored roots
                y = [sum(v[r] * roots[R][(r * s) % R] for r in range(R))
                     for s in range(R)]
            b = np.empty_like(a)
            d = t * m + (j - k) * R + k
            for s in range(R):
                b[d + s * ns] = y[s]
            a = b
            o += R * ns
            ns *= R
        return a

    len1 = sum(r * ns for r, ns in acquire2.wide_passes(n1))
    k1, k2 = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    cols = sub(X[(k2 + n2 * k1).T].reshape(-1), n1, len(hdr))  # [k2][j1]
    row = (cols.reshape(n2, n1).T * root[k1 * k2]).reshape(-1)  # [j1][k2]
    x = sub(row, n2, len(hdr) + len1).reshape(n1, n2)           # [j1][j2]
    j = np.arange(W)
    return x[j % n1, j // n1] / W


@pytest.mark.parametrize("W", [6, 1280, 20460, 30690, 81920])
def test_four_step_plan_is_the_inverse_dft(W):
    rng = np.random.default_rng(W)
    X = rng.standard_normal(W) + 1j * rng.standard_normal(W)
    np.testing.assert_allclose(_four_step_ifft(X, W), np.fft.ifft(X),
                               rtol=0, atol=2e-6 * np.abs(X).max())
    tw = acquire2.wide_twiddle_table(*acquire2.wide_split(W))
    assert tw.dtype == np.complex64 and np.abs(np.abs(tw) - 1).max() < 1e-6


def _cluster_stride(m):
    return (m + (m >> 4)) | 1


def _cluster_ifft(X, n1, n2, C):
    """The cluster kernels' unscaled inverse DFT (csrc/acq_cluster.cuh),
    step for step, one flat buffer pair per rank: the rank's columns
    loaded in the column layout, the column passes, the transpose read
    from the owning rank's buffer at at(tc, S1, j1) times the two-table
    twiddle A[t mod n2] * B[t div n2], the row passes, and each rank's
    lags read out of its row layout.  Returns (x, owner): x[j] for the
    natural lags and owner[j] the rank that produced lag j."""
    W = n1 * n2
    tw = acquire2.cluster_twiddle_table(n1, n2).astype(np.complex128)
    hdr = 16 + sum(acquire2.WIDE_ROOTS)
    passes, off = [], hdr
    for m in (n1, n2):              # make_sub: tables after the header
        ps = []
        for R, ns in acquire2.wide_passes(m):
            ps.append((R, ns, off))
            off += R * ns
        passes.append(ps)
    twA, twB = tw[off:off + n2], tw[off + n2:off + n2 + n1]
    assert len(tw) == off + n2 + n1
    nc, nr = -(-n2 // C), -(-n1 // C)
    assert (C - 1) * nc < n2 and (C - 1) * nr < n1
    S1, S2 = _cluster_stride(n1), _cluster_stride(n2)
    size = max(nc * S1, nr * S2)

    def at(t, S, e):
        return t * S + e + (e >> 4)

    def sub(a, nb, m, S, ps):       # out-of-place Stockham passes
        for R, ns, o in ps:
            items = m // R
            u = np.arange(nb * items)
            t, j = u // items, u % items
            k = j % ns
            v = np.stack([a[at(t, S, j + r * items)]
                          * (tw[o + r * ns + k] if r and ns > 1 else 1)
                          for r in range(R)])
            y = np.exp(2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R
                       ) @ v
            b = np.zeros_like(a)
            d = (j // ns) * ns * R + k
            for s in range(R):
                b[at(t, S, d + s * ns)] = y[s]
            a = b
        return a

    share = [(r * nc, min(nc, n2 - r * nc), r * nr, min(nr, n1 - r * nr))
             for r in range(C)]
    cols = []
    for c0, ncr, _, _ in share:     # load, then the column passes
        buf = np.zeros(size, complex)
        e = np.arange(ncr * n1)
        k1, t = e // ncr, e % ncr
        buf[at(t, S1, k1)] = X[c0 + t + n2 * k1]
        cols.append(sub(buf, ncr, n1, S1, passes[0]))
    x = np.zeros(W, complex)
    owner = np.full(W, -1)
    for r, (_, _, j10, nrr) in enumerate(share):
        e = np.arange(nrr * n2)
        k2, jl = e // nrr, e % nrr  # consecutive threads: consecutive j1
        src, j1 = k2 // nc, j10 + jl
        tc = k2 - src * nc
        v = np.array([cols[s][at(c, S1, j)] for s, c, j in zip(src, tc, j1)])
        tt = j1 * k2
        buf = np.zeros(size, complex)
        buf[at(jl, S2, k2)] = v * twA[tt % n2] * twB[tt // n2]
        out = sub(buf, nrr, n2, S2, passes[1])
        t, j2 = e // n2, e % n2     # the lags of this rank's row layout
        lag = j10 + t + n1 * j2
        assert (owner[lag] == -1).all()
        x[lag] = out[at(t, S2, j2)]
        owner[lag] = r
    return x, owner


def check_cluster_transform(n1, n2, C):
    """The cluster core's emulation against np.fft.ifft: every lag made by
    exactly one rank, rank r owning the rows j1 in [r*nr, (r+1)*nr), and
    the result the inverse DFT to float32 twiddle rounding (2e-6 of the
    input's scale per point); the two-table twiddle w^t to float32
    rounding for every t < W."""
    W = n1 * n2
    rng = np.random.default_rng(W + C)
    X = rng.standard_normal(W) + 1j * rng.standard_normal(W)
    x, owner = _cluster_ifft(X, n1, n2, C)
    np.testing.assert_allclose(x / W, np.fft.ifft(X), rtol=0,
                               atol=2e-6 * np.abs(X).max())
    nr = -(-n1 // C)
    assert (owner == (np.arange(W) % n1) // nr).all()
    # the two-table twiddle is w^t to float32 rounding for every t < W
    tw = acquire2.cluster_twiddle_table(n1, n2)
    t = np.arange(W)
    A, B = tw[len(tw) - n1 - n2:len(tw) - n1], tw[len(tw) - n1:]
    np.testing.assert_allclose(A[t % n2].astype(np.complex128) * B[t // n2],
                               np.exp(2j * np.pi * t / W), rtol=0, atol=3e-7)


@pytest.mark.parametrize("n1,n2,C", [(165, 186, 2), (165, 186, 3),
                                     (165, 186, 4), (30, 32, 1),
                                     (256, 256, 8)])
def test_cluster_transform_is_the_inverse_dft(n1, n2, C):
    """K7's cluster core at Xona X5's 30690 = 165 x 186 over 2, 3 and 4
    ranks (4 is the kernel's choice), and at the card tests' 960 (one
    CTA) and 65536 (eight)."""
    check_cluster_transform(n1, n2, C)


def test_k7_plain_matches_pallas_kernel_interpret():
    import jax.numpy as jnp

    from gnss_dsp_tpu.ops import cplx, fft as fftm
    from gnss_dsp_tpu.ops import pallas_acquire as pa

    W, P, DC, B, bt = 30690, 2, 1, 4, 2
    n1, n2 = pa.plan2(W)
    rng = np.random.default_rng(30690)
    x = rng.standard_normal((DC, B, W)) + 1j * rng.standard_normal((DC, B, W))
    c = rng.standard_normal((P, W)) + 1j * rng.standard_normal((P, W))
    C_ref = np.fft.fft(c, axis=-1)

    def bf16(a):
        return (jnp.asarray(a.real.astype(np.float32)).astype(jnp.bfloat16),
                jnp.asarray(a.imag.astype(np.float32)).astype(jnp.bfloat16))

    Fp = fftm.fft_two_level_perm(cplx.from_numpy(x), bf16=True)
    F16 = (Fp[0].astype(jnp.bfloat16), Fp[1].astype(jnp.bfloat16))
    code16 = bf16(pa.permute_host(C_ref))
    q = np.asarray(pa.corr_surface(F16, code16, n1=n1, n2=n2, bt=bt,
                                   interpret=True))
    q_nat = np.empty_like(q)
    q_nat[..., pa.perm_to_natural_index(np.arange(W), W)] = q

    got = acquire.corr_surface_plain(
        torch.from_numpy(np.fft.fft(x, axis=-1).astype(np.complex64)),
        torch.from_numpy(C_ref.astype(np.complex64))).numpy()
    assert got.shape == (P, DC, W) and got.dtype == np.float32
    assert np.abs(got - q_nat).max() < 2e-2 * np.abs(q_nat).max()

    shift = 12345                 # x = code delayed by shift samples
    F2 = np.fft.fft(np.roll(c[0], shift))[None, None, :]
    q2 = acquire.corr_surface_plain(
        torch.from_numpy(F2.astype(np.complex64)),
        torch.from_numpy(C_ref.astype(np.complex64))).numpy()
    assert int(np.argmax(q2[0, 0])) == (W - shift) % W


def test_k7_wrapper_refuses_cpu_tensors():
    F = torch.zeros((1, 2, 30690), dtype=torch.complex64)
    code = torch.zeros((1, 30690), dtype=torch.complex64)
    n0 = acquire.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        acquire.corr_surface(F, code)
    assert acquire.LAUNCHES == n0


def test_k1_plain_n_valid_matches_pallas_kernel_interpret():
    import jax.numpy as jnp

    from gnss_dsp_tpu.ops import cplx, fft as fftm
    from gnss_dsp_tpu.ops import pallas_acquire2 as pa2

    rng = np.random.default_rng(1000)
    n = 1000
    dw = 2 * n
    n1, n2, W = pa2.plan_padded(dw)
    g = pa2.pick_g(n1)
    P, DC, B, bt = 2, 1, 2 * g, g
    cp0 = 317
    code = rng.choice([-1.0, 1.0], size=(P, n))
    c = np.zeros((P, W), complex)
    c[:, :n] = code
    t = np.arange(dw)
    x = np.zeros((DC, B, W), complex)
    x[0, :, :dw] = (code[0][(t - cp0) % n]
                    + 0.1 * (rng.standard_normal((B, dw))
                             + 1j * rng.standard_normal((B, dw))))
    F_ref = np.fft.fft(x, axis=-1)
    C_ref = np.fft.fft(c, axis=-1)

    Fp = fftm.fft_two_level_perm(cplx.from_numpy(x), bf16=True, n1=n1)
    F16 = (Fp[0].astype(jnp.bfloat16), Fp[1].astype(jnp.bfloat16))
    Cp = pa2.permute_host2(C_ref, n1, n2)
    code_f = (jnp.asarray(Cp.real.astype(np.float32)).astype(jnp.bfloat16),
              jnp.asarray(Cp.imag.astype(np.float32)).astype(jnp.bfloat16))
    peak_j, idx_j, sum_j = (np.asarray(v) for v in pa2.corr_surface2(
        F16, code_f, n1=n1, n2=n2, bt=bt, reduce=True, n_valid=n,
        interpret=True))

    peak, idx, sm = (v.numpy() for v in acquire2.corr_surface2(
        torch.from_numpy(F_ref.astype(np.complex64)),
        torch.from_numpy(C_ref.astype(np.complex64)), n))
    scale = float(peak_j.max())
    np.testing.assert_array_equal(idx, idx_j)
    assert int(idx[0, 0]) == n - cp0
    np.testing.assert_allclose(peak, peak_j, atol=2e-2 * scale)
    np.testing.assert_allclose(sm, sum_j, rtol=3e-2)


@pytest.mark.parametrize("n_valid", [0, 640])
def test_k1_plain_at_a_non_power_of_two_window(n_valid):
    W, P, DC, B = 1280, 3, 2, 4            # 1280 = 2 x 640
    rng = np.random.default_rng(W + n_valid)
    code = np.exp(2j * np.pi * rng.random((P, W)))
    F = rng.standard_normal((DC, B, W)) + 1j * rng.standard_normal((DC, B, W))
    k = np.arange(W)
    plants = [(0, 1, 1000), (1, 0, 700), (2, 1, 1279)]
    for p, d, j in plants:           # surface peaks at lag j
        F[d] += 2.0 * code[p] * np.exp(2j * np.pi * k * j / W)
    q = np.abs(np.fft.ifft(code[:, None, None, :] * np.conj(F)[None],
                           axis=-1)).sum(axis=2)
    lo = W - n_valid if n_valid else 0
    q = q[..., lo:]
    peak, idx, sm = (v.numpy() for v in acquire2.corr_surface2(
        torch.from_numpy(F.astype(np.complex64)),
        torch.from_numpy(code.astype(np.complex64)), n_valid))
    for p, d, j in plants:
        assert int(idx[p, d]) == j - lo
    np.testing.assert_array_equal(idx, q.argmax(-1))
    np.testing.assert_allclose(peak, q.max(-1), rtol=1e-5)
    np.testing.assert_allclose(sm, q.sum(-1), rtol=1e-5)


# ----------------------------------------------- acquire_signal vs the JAX one

# one signal per route and template: (name, ms, prns, planted
# (prn, doppler, code phase) rows, doppler grid); planted dopplers a little
# off the grid
ENGINE_CASES = [
    ("xona-x5d", 3, (0,), [(0, 1010.0, 5000.25)],                     # v1
     (0.0, 2000.0, 500.0)),
    ("gps-l5i", 3, (25, 1, 7), [(25, 3010.0, 5000.25), (7, -990.0, 88.0)],
     (-2000.0, 4000.0, 1000.0)),                                      # v2p
    ("galileo-e1b", 12, (11, 4, 19), [(11, 1505.0, 3001.5)],          # sliding
     (0.0, 3000.0, 500.0)),
    ("gps-l1cp", 20, (9, 2), [(9, -495.0, 7777.0)],                   # 81920
     (-1500.0, 1000.0, 500.0)),
    ("gps-l2cm", 60, (14, 3), [(14, 805.0, 4321.0)],                  # 163840
     (0.0, 1600.0, 400.0)),
]
SUBC = {"gps-l1cp": "tmboc", "galileo-e1b": "cboc", "gps-l2cm": "rz_even"}


def _capture(sig, ms, plants):
    from gnss_dsp_tpu_torch.utils.synth import synth_iq

    fs = sig.acq_fs
    n = int(fs * (ms + 4) / 1000.0)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in plants:
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                      doppler_hz=dop, code_phase=cp, cn0_dbhz=None,
                      subcarrier=SUBC.get(sig.name, "none"),
                      carrier_ratio=sig.carrier_ratio)
    return x


def _reference_cell(jsig, x, prn, ms, doppler, code):
    """The JAX engine's own surface (chunk_q, float32) at `doppler`, read
    at the highest of the lags that report code offset `code`."""
    import jax
    import jax.numpy as jnp

    from gnss_dsp_tpu.acquire import engine as jeng
    from gnss_dsp_tpu.ops import cplx
    from gnss_dsp_tpu.ops import nco as jnco

    n = int(round(jsig.acq_fs * jsig.acq_coherent_ms / 1000.0))
    window = 2 * n if (jsig.acq_pad2 or jsig.acq_sliding) else n
    dops, fixed = jeng.doppler_grid(jsig, (doppler, doppler + 1.0, 2.0))
    cf = jeng.build_code_ffts(jsig, (prn,), n, window)
    xb = jeng.block_windows(cplx.from_numpy(x), n, window,
                            jeng._block_count(jsig, ms))
    w = jnco.nco_split(jnp.int32(fixed[0]), jnp.uint32(0), window)
    q = np.asarray(jeng.chunk_q(xb, cplx.from_numpy(cf),
                                (w[0][None], w[1][None]),
                                jax.lax.Precision.HIGHEST))[0, 0]
    L = jsig.code_length
    codes = (L * np.arange(window, dtype=np.float64) / n) % L
    return float(q[np.abs(codes - code) < 1e-6].max())


@pytest.mark.parametrize("case", ENGINE_CASES, ids=[c[0] for c in ENGINE_CASES])
def test_acquire_signal_matches_jax(case):
    from gnss_dsp_tpu.acquire import engine as jeng
    from gnss_dsp_tpu.models import get_signal as jget
    from gnss_dsp_tpu_torch.acquire import engine as teng

    name, ms, prns, plants, grid = case
    sig, jsig = get_signal(name), jget(name)
    x = _capture(sig, ms, plants)
    want = jeng.acquire_signal(jsig, x, prns, doppler_search=grid, ms=ms)
    got = teng.acquire_signal(sig, torch.from_numpy(x), prns,
                              doppler_search=grid, ms=ms)
    route = acq_plan(sig)[0]
    planted = {p for p, _, _ in plants}
    assert [r.prn for r in got] == list(prns)
    for a, b in zip(want, got):
        if route == "v2p" and b.prn not in planted:
            assert b.metric <= a.metric * (1 + 1e-5)
            continue
        assert abs(b.metric - a.metric) <= 2.4e-3 * abs(a.metric)
        if (b.doppler, b.code_offset) != (a.doppler, a.code_offset):
            # only where the reference surface ties at both cells to
            # float32 rounding (the flat top of an RZ or BOC correlation)
            va = _reference_cell(jsig, x, a.prn, ms, a.doppler, a.code_offset)
            vb = _reference_cell(jsig, x, b.prn, ms, b.doppler, b.code_offset)
            assert abs(va - vb) <= 1e-5 * va, (a, b, va, vb)
    absent = [q.metric for q in got if q.prn not in planted]
    for prn, dop, cp in plants:           # the planted PRNs win their cells
        r = got[prns.index(prn)]
        dc = abs(r.code_offset - cp) % sig.code_length
        assert abs(r.doppler - dop) <= 10.0
        assert min(dc, sig.code_length - dc) <= 1.0
        assert r.metric > max(absent, default=0.0)
