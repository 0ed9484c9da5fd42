"""The port's extended-coherent acquisition (gnss_dsp_tpu_torch) against
the JAX package, on the CPU.

  * K6's plain version against pallas_acquire_coh.corr_surface_coh in
    interpret mode, on the circular (W=2048, lane-packed g=8) and padded
    (n_valid) shapes of tests/test_pallas_coh.py, and K5's plain version
    against corr_surface_coh_spec at that file's W=16384 shape, at 65536
    padded (n_valid 30690) and at 81920.  Both get
    the same bf16-rounded spectra.  idx and align exact; peak within 3e-2
    of the largest peak (the bound the TPU kernels' bf16 Karatsuba IDFT
    meets against the float64 oracle);
  * acquire_signal_coherent against the JAX engine="fused" (interpret
    mode) on the B1I NH20 planted capture, the per-PRN-overlay capture,
    the 25-chip FFT-combine capture and, at their catalog windows, GPS
    L5Q (65536 padded), Galileo E1C (65536, CS25) and Galileo E6C (32768
    padded, CS100 per PRN): PRN, doppler, code offset, align, linear and
    track_overlay_phase equal, metric within 3e-2;
  * engine="xla" against the JAX XLA engine on tests/test_coherent.py's
    L5I and no-secondary cases: metric rtol 1e-4, the rest exact;
  * the CLI with --coherent 8 against the JAX CLI (its fused route in
    interpret mode) on a short GPS L1 capture: prn, doppler and
    code_offset fields identical, metric to rtol 3e-2 (bf16 IDFT);
  * a fused window the CUDA kernels do not take is refused on CUDA, and
    the CLI refuses FDMA --coherent and the unknown --mesh option (not
    ported).
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch import interop
from gnss_dsp_tpu_torch.ops import acquire_coh

SEC4 = np.array([1.0, 1.0, -1.0, 1.0])       # no cyclic self-symmetry


def _bf16_split(a, n1, n2):
    import jax.numpy as jnp

    from gnss_dsp_tpu.ops import pallas_acquire2 as pa2

    ap = pa2.permute_host2(a, n1, n2)
    return (jnp.asarray(ap.real.astype(np.float32)).astype(jnp.bfloat16),
            jnp.asarray(ap.imag.astype(np.float32)).astype(jnp.bfloat16))


def _natural(split, n1, n2):
    return interop.code_ffts_from_split(
        np.asarray(split[0], np.float32), np.asarray(split[1], np.float32),
        plan=("v2", n1, n2))


def _planted_blocks(rng, P, DC, B, W, dw, code, sec_mat, a_true, cp0, d0):
    """Noise in the first dw samples of each block window, plus PRN 0's
    code delayed by cp0 at doppler row d0 carrying overlay chip
    sec_mat[a_true, m] and a residual rotation per block."""
    n = code.shape[1]
    t = np.arange(dw)
    x = np.zeros((DC, B, W), complex)
    x[:, :, :dw] = 0.05 * (rng.standard_normal((DC, B, dw))
                           + 1j * rng.standard_normal((DC, B, dw)))
    ang = rng.uniform(-np.pi, np.pi, size=(DC, B))
    rot = np.cos(ang) + 1j * np.sin(ang)
    for m in range(B):
        x[d0, m, :dw] += sec_mat[a_true, m] * rot[d0, m] * code[0][
            (t - cp0) % n]
    return x, ang


def _same_surface(got, want, peak_tol=3e-2):
    peak_t, idx_t, al_t = (v.numpy() for v in got)
    peak_j, idx_j, al_j = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(al_t, al_j)
    np.testing.assert_allclose(peak_t, peak_j, rtol=0,
                               atol=peak_tol * peak_j.max())
    assert idx_t.dtype == al_t.dtype == np.int32


@pytest.mark.parametrize("padded", [False, True], ids=["circular", "padded"])
def test_k6_plain_matches_pallas_kernel_interpret(padded):
    import jax.numpy as jnp

    from gnss_dsp_tpu.ops import cplx, fft as fftm
    from gnss_dsp_tpu.ops import pallas_acquire2 as pa2
    from gnss_dsp_tpu.ops.pallas_acquire_coh import corr_surface_coh

    rng = np.random.default_rng(7)
    A, m_coh, bt = 4, 8, 8
    if padded:
        n = 1000
        n1, n2, W = pa2.plan_padded(2 * n)
        P, DC, B, dw, n_valid = 1, 2, 8, 2 * n, n
        code = np.zeros((P, W))
        code[:, :n] = rng.choice([-1.0, 1.0], size=(P, n))
        a_true, cp0, d0 = 1, 317, 0
        x, ang = _planted_blocks(rng, P, DC, B, W, dw, code[:, :n],
                                 SEC4[(np.arange(A)[:, None]
                                       + np.arange(B)[None, :]) % A],
                                 a_true, cp0, d0)
    else:
        W = 2048
        n1, n2 = pa2.plan_aligned(W)
        assert pa2.pick_g(n1) == 8
        P, DC, B, n_valid = 2, 3, 16, 0
        code = rng.choice([-1.0, 1.0], size=(P, W))
        a_true, cp0, d0 = 2, 613, 1
        x, ang = _planted_blocks(rng, P, DC, B, W, W, code,
                                 SEC4[(np.arange(A)[:, None]
                                       + np.arange(B)[None, :]) % A],
                                 a_true, cp0, d0)
    sec_mat = SEC4[(np.arange(A)[:, None] + np.arange(B)[None, :]) % A]
    Fp = fftm.fft_two_level_perm(cplx.from_numpy(x), bf16=True, n1=n1)
    F16 = (Fp[0].astype(jnp.bfloat16), Fp[1].astype(jnp.bfloat16))
    C16 = _bf16_split(np.fft.fft(code, axis=-1), n1, n2)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    want = corr_surface_coh(F16, C16, jnp.asarray(cos), jnp.asarray(sin),
                            jnp.asarray(sec_mat.astype(np.float32)), n1=n1,
                            n2=n2, bt=bt, m_coh=m_coh, n_valid=n_valid,
                            interpret=True)
    got = acquire_coh.corr_surface_coh(
        _natural(F16, n1, n2), _natural(C16, n1, n2), torch.from_numpy(cos),
        torch.from_numpy(sin), torch.from_numpy(sec_mat.astype(np.float32)),
        m_coh, n_valid)
    _same_surface(got, want)
    lag = n_valid - cp0 if padded else (W - cp0) % W
    assert (int(got[1][0, d0]), int(got[2][0, d0])) == (lag, a_true)


@pytest.mark.parametrize("W,n_valid,P", [(16384, 0, 2), (65536, 30690, 1),
                                         (81920, 0, 1)],
                         ids=["16384", "65536_padded", "81920"])
def test_k5_plain_matches_pallas_kernel_interpret(W, n_valid, P):
    """K5's plain version against the Pallas kernel (interpret mode) on
    the same bf16-rounded combined rows, at B1I's 16384 = 128 x 128, the
    padded L5/E5/B2a/B3I/L3OC window 65536 = 256 x 256 (n_valid 30690:
    data in the first 2n samples of each window, the code zero-padded)
    and GPS L1C's 81920 = 128 x 640 in the TPU plan (G*A = 8 rows), a
    planted cell at each doppler (noise alone ties to bf16 rounding)."""
    import jax.numpy as jnp

    from gnss_dsp_tpu.ops import cplx, fft as fftm
    from gnss_dsp_tpu.ops import pallas_acquire2 as pa2
    from gnss_dsp_tpu.ops.pallas_acquire_coh import corr_surface_coh_spec

    rng = np.random.default_rng(7)
    n1, n2 = pa2.plan_aligned(W)
    assert pa2.pick_g(n1) == 1
    DC, m_coh, A, B, G = 2, 4, 4, 8, 2
    sec_mat = SEC4[(np.arange(A)[:, None] + np.arange(B)[None, :]) % A]
    n = n_valid or W                         # code samples
    code = np.zeros((P, W))
    code[:, :n] = rng.choice([-1.0, 1.0], size=(P, n))
    a_true, cp0, d0 = 3, 4000, 1
    dw = 2 * n if n_valid else W
    x, ang = _planted_blocks(rng, P, DC, B, W, dw, code[:, :n], sec_mat,
                             a_true, cp0, d0)
    a1, cp1 = 1, 1234                        # doppler 0's cell
    t = np.arange(dw)
    for m in range(B):
        x[0, m, :dw] += (sec_mat[a1, m] * np.exp(1j * ang[0, m])
                         * code[0][(t - cp1) % n])
    # the spectral combine of grid_search_coherent_fast(mode="spec")
    Fp = fftm.fft_two_level_perm(cplx.from_numpy(x), bf16=True, n1=n1)
    F = (np.asarray(Fp[0], np.float32), np.asarray(Fp[1], np.float32))
    wg = ((sec_mat[None] * np.cos(ang)[:, None, :]).reshape(DC, A, G, m_coh),
          (-sec_mat[None] * np.sin(ang)[:, None, :]).reshape(DC, A, G, m_coh))
    Fg = (F[0].reshape(DC, G, m_coh, W), F[1].reshape(DC, G, m_coh, W))

    def es(a, b):
        return np.einsum("dagm,dgmw->dgaw", a, b)

    F2 = (jnp.asarray((es(wg[0], Fg[0]) - es(wg[1], Fg[1])
                       ).reshape(DC, G * A, W)).astype(jnp.bfloat16),
          jnp.asarray((es(wg[0], Fg[1]) + es(wg[1], Fg[0])
                       ).reshape(DC, G * A, W)).astype(jnp.bfloat16))
    C16 = _bf16_split(np.fft.fft(code, axis=-1), n1, n2)
    want = corr_surface_coh_spec(F2, C16, n1=n1, n2=n2, bt=4, A=A,
                                 n_valid=n_valid, interpret=True)
    got = acquire_coh.corr_surface_coh_spec(
        _natural(F2, n1, n2), _natural(C16, n1, n2), A, n_valid)
    _same_surface(got, want)
    for d, a, cp in ((d0, a_true, cp0), (0, a1, cp1)):
        lag = n_valid - cp if n_valid else (W - cp) % W
        assert (int(got[1][0, d]), int(got[2][0, d])) == (lag, a)


def _split(N):
    """csrc/acq_cluster.cuh Split<N>: step A on Q threads of R values, H
    step-C transforms a thread, step C on QO threads of RO values; N = 320
    is 16 threads of 20 values, then 20 threads of 16."""
    if N == 320:
        return 20, 16, 1, 16, 20
    R = min(N, 16)
    return R, N // R, R // (N // R), R, N // R


def _split_index(N, o, t):
    R, Q, H, _, _ = _split(N)
    if N == 320:
        return t + R * o
    return t * H + o // Q + R * (o % Q)


def _roots(k, n):
    """unit_root: e^{2 pi i k/n} from float64, rounded to complex64."""
    return np.exp(2j * np.pi * np.asarray(k) / n).astype(np.complex64
                                                          ).astype(complex)


def _split_ab(x, N, t):
    """Steps A and B for thread t of every transform: x [m, col] (m in
    natural order) -> v [a, col]."""
    R, Q, _, _, _ = _split(N)
    a = np.arange(R)
    v = np.exp(2j * np.pi * np.outer(a, a) / R) @ x
    return v * (_roots(a * t, N)[:, None] if Q > 1 else 1)


def _split_transform(X, n1, n2, C):
    """The cluster register core's unscaled inverse DFT of one row
    (csrc/acq_cluster.cuh surface_rows), address for address, over C
    ranks: the staged [k1][col] slice of each rank (nc = n2/C columns),
    the column role's registers and exchange buffer xb[(a*Q1 + t)*nc +
    col], the four-step twiddle w^(j1*k2) = w^((t*H1 + h)*k2) *
    w^(R1*b*k2) for cell j1 = t*H1 + h + R1*b, each factor from the two
    small tables (w^t = A[t mod n2] * B[t div n2]), the store to
    yb[col*(n1 + 1) + j1], the row role's reads of yb[(k2 mod nc)*(n1 +
    1) + j1] in rank k2 div nc, and its exchange xb[(a*Q2 + t)*nr + jl]
    (step C on QO2 threads).  Returns (x, owner): x[j] for the natural lags
    and owner[j] the rank that produced lag j.  Every shared-memory slot
    is written at most once a phase and read only once written."""
    W = n1 * n2
    R1, Q1, H1, _, _ = _split(n1)
    R2, Q2, H2, RO2, QO2 = _split(n2)
    nc, nr, ys = n2 // C, n1 // C, n1 + 1
    assert nc * C == n2 and nr * C == n1 and len(X) == W
    wA, wB = _roots(np.arange(n2), W), _roots(np.arange(n1), n1)

    def w_of(t):                        # the two-table twiddle
        t = t % W
        return wA[t % n2] * wB[t // n2]

    yb = []
    for r in range(C):
        k1, col = np.divmod(np.arange(W // C), nc)
        stage = X[r * nc + col + n2 * k1]                 # [k1][col]
        xb = np.full(W // C, np.nan, complex)
        ys_r = np.full(nc * ys, np.nan, complex)
        vs = []
        for t in range(Q1):             # column role: tid = t*nc + col
            m = np.arange(R1)
            v = _split_ab(stage[((t + Q1 * m)[:, None] * nc
                                 + np.arange(nc)[None, :])], n1, t)
            if Q1 > 1:
                slots = (np.arange(R1)[:, None] * Q1 + t) * nc \
                    + np.arange(nc)[None, :]
                assert np.isnan(xb[slots]).all()
                xb[slots] = v
            vs.append(v)
        for t in range(Q1):
            out = np.zeros((R1, nc), complex)
            for o in range(R1):
                h, b = divmod(o, Q1)
                if Q1 > 1:              # step C over xb
                    a = t * H1 + h
                    u = xb[(a * Q1 + np.arange(Q1))[:, None] * nc
                           + np.arange(nc)[None, :]]
                    assert not np.isnan(u).any()
                    out[o] = np.exp(2j * np.pi * b * np.arange(Q1) / Q1) @ u
                else:
                    out[o] = vs[t][o]
            k2 = r * nc + np.arange(nc)
            for o in range(R1):
                h, b = divmod(o, Q1)
                j1 = _split_index(n1, o, t)
                assert j1 == t * H1 + h + R1 * b
                slot = np.arange(nc) * ys + j1
                assert np.isnan(ys_r[slot]).all()
                # w^(j1*k2) = gb[h] * wS[b][col], each a two-table product
                ys_r[slot] = out[o] * w_of((t * H1 + h) * k2) \
                    * w_of(R1 * b * k2)
        yb.append(ys_r)
    x = np.zeros(W, complex)
    owner = np.full(W, -1)
    for r in range(C):
        jl = np.arange(nr)
        j1 = r * nr + jl
        xb = np.full(W // C, np.nan, complex)
        zs = []
        for t in range(Q2):             # row role, step A: tid = t*nr + jl
            k2 = t + Q2 * np.arange(R2)
            z = np.stack([yb[k // nc][(k % nc) * ys + j1] for k in k2])
            assert not np.isnan(z).any()
            z = _split_ab(z, n2, t)
            if Q2 > 1:
                slots = (np.arange(R2)[:, None] * Q2 + t) * nr + jl[None, :]
                assert np.isnan(xb[slots]).all()
                xb[slots] = z
            zs.append(z)
        for t in range(QO2):            # step C: tid = t*nr + jl
            for o in range(RO2):
                if Q2 > 1:
                    a, b = (t, o) if n2 == 320 else \
                        (t * H2 + o // Q2, o % Q2)
                    u = xb[(a * Q2 + np.arange(Q2))[:, None] * nr
                           + jl[None, :]]
                    assert not np.isnan(u).any()
                    val = np.exp(2j * np.pi * b * np.arange(Q2) / Q2) @ u
                else:
                    val = zs[t][o]
                lag = j1 + n1 * _split_index(n2, o, t)
                assert (owner[lag] == -1).all()
                x[lag] = val
                owner[lag] = r
    return x, owner


def _spec_transform(X, L, C):
    """K5's unscaled inverse DFT of one row at W = 2^L over C ranks
    (csrc/acquire_coh_spec.cu on surface_rows): _split_transform at
    n1 = 2^floor(L/2)."""
    return _split_transform(X, 1 << (L // 2), 1 << (L - L // 2), C)


@pytest.mark.parametrize("L,C", [(14, 2), (14, 4), (14, 8), (13, 8),
                                 (9, 8), (5, 4), (1, 1)])
def test_k5_cluster_transform_is_the_inverse_dft(L, C):
    """K5's cluster core (csrc/acquire_coh_spec.cu) emulated in numpy at
    the B1I window 16384 = 128 x 128 over 2, 4 and 8 ranks (8 is the
    kernel's choice, 4 its other build) and at the card tests' 8192 and
    512 and two small windows: each lag made by exactly one rank, rank r
    owning the rows j1 in [r*nr, (r+1)*nr), and the result the inverse
    DFT to float32 twiddle rounding (2e-6 of the input's scale)."""
    W = 1 << L
    n1 = 1 << (L // 2)                  # n1 = 2^floor(log2(W)/2)
    rng = np.random.default_rng(W + C)
    X = rng.standard_normal(W) + 1j * rng.standard_normal(W)
    x, owner = _spec_transform(X, L, C)
    np.testing.assert_allclose(x / W, np.fft.ifft(X), rtol=0,
                               atol=2e-6 * np.abs(X).max())
    assert (owner == (np.arange(W) % n1) // (n1 // C)).all()


def test_k5_plain_is_k6_plain_on_combined_rows():
    """The spectral combine is the per-block coherent sum (linearity of
    the IDFT): K5 on combined rows == K6 on the blocks, incl. n_valid."""
    rng = np.random.default_rng(3)
    P, DC, A, m_coh, G, W, n_valid = 3, 2, 4, 4, 2, 256, 100
    B = G * m_coh
    sec_mat = SEC4[(np.arange(A)[:, None] + np.arange(B)[None, :]) % A]
    code = np.exp(2j * np.pi * rng.random((P, W)))
    F = rng.standard_normal((DC, B, W)) + 1j * rng.standard_normal((DC, B, W))
    ang = rng.uniform(-np.pi, np.pi, size=(DC, B))
    wc = sec_mat[None] * np.exp(-1j * ang)[:, None, :]        # conj(w)
    F2 = np.einsum("dagm,dgmw->dgaw", wc.reshape(DC, A, G, m_coh),
                   F.reshape(DC, G, m_coh, W)).reshape(DC, G * A, W)

    def c64(a):
        return torch.from_numpy(a.astype(np.complex64))

    def f32(a):
        return torch.from_numpy(a.astype(np.float32))

    k5 = acquire_coh.corr_surface_coh_spec(c64(F2), c64(code), A, n_valid)
    k6 = acquire_coh.corr_surface_coh(c64(F), c64(code), f32(np.cos(ang)),
                                      f32(np.sin(ang)), f32(sec_mat), m_coh,
                                      n_valid)
    torch.testing.assert_close(k5[0], k6[0], rtol=1e-5, atol=0)
    assert torch.equal(k5[1], k6[1]) and torch.equal(k5[2], k6[2])
    assert int(k5[1].max()) < n_valid


# ------------------------------------------------------------ the engines

def _b1i_nh20_capture(rng):
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq

    sig = dataclasses.replace(get_signal("beidou-b1i"), acq_fs=4.096e6)
    prn = 34
    n = int(sig.acq_fs * 0.046)
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, sig.acq_fs, n,
                 doppler_hz=20.0, code_phase=500.0, cn0_dbhz=None,
                 carrier_ratio=sig.carrier_ratio,
                 data_bits=np.roll(sig.secondary(prn), -3), rng=rng)
    return sig, x, [prn], (-40.0, 41.0, 20.0), 40


def _per_prn_capture(rng, n_chips, ms, grid, plants):
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq

    base = get_signal("beidou-b1i")
    rngo = np.random.default_rng(3 if n_chips == 20 else 9)
    ovls = {p: rngo.choice([-1, 1], n_chips).astype(np.int8)
            for p in (5, 34)}
    sig = dataclasses.replace(base, secondary=lambda p: ovls[p])
    n = int(sig.acq_fs * (ms + 6) / 1000)
    x = np.zeros(n, np.complex64)
    for prn, (dop, cp) in plants.items():
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate,
                      sig.acq_fs, n, doppler_hz=dop, code_phase=cp,
                      cn0_dbhz=None, carrier_ratio=sig.carrier_ratio,
                      data_bits=ovls[prn], rng=rng)
    return sig, x, [5, 34], grid, ms


def _catalog_capture(rng, name, plants, ms, grid, roll=3):
    """Noiseless PRNs of catalog signal `name` at its own acq_fs and
    subcarrier, each carrying its own overlay from chip `roll`: the
    fused route at the signal's catalog window."""
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq

    sig = get_signal(name)
    n = int(sig.acq_fs * (ms + 6) / 1000)
    x = np.zeros(n, np.complex64)
    for prn, (dop, cp) in plants.items():
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, sig.acq_fs,
                      n, doppler_hz=dop, code_phase=cp, cn0_dbhz=None,
                      subcarrier=sig.subcarrier,
                      carrier_ratio=sig.carrier_ratio,
                      data_bits=np.roll(sig.secondary(prn), -roll), rng=rng)
    return sig, x, sorted(plants), grid, ms


CAPTURES = {
    "b1i_nh20": lambda rng: _b1i_nh20_capture(rng),
    # 65536 padded (n_valid 30690), NH20 shared, the einsum combine
    "gps_l5q": lambda rng: _catalog_capture(
        rng, "gps-l5q", {7: (25.0, 3210.0), 30: (-25.0, 8000.5)}, 20,
        (-25.0, 26.0, 25.0)),
    # 65536 = 2n linear, CS25 shared, the FFT combine
    "galileo_e1c": lambda rng: _catalog_capture(
        rng, "galileo-e1c", {11: (5.0, 1000.0)}, 100, (-5.0, 6.0, 5.0)),
    # 32768 padded (n_valid 15345), CS100 per PRN: one K5 call a PRN
    "galileo_e6c": lambda rng: _catalog_capture(
        rng, "galileo-e6c", {3: (5.0, 700.0), 19: (-5.0, 4100.0)}, 100,
        (-5.0, 6.0, 5.0)),
    "per_prn_overlays": lambda rng: _per_prn_capture(
        rng, 20, 40, (-40.0, 41.0, 20.0),
        {5: (20.0, 500.0), 34: (-20.0, 1200.0)}),
    "fft_combine_25": lambda rng: _per_prn_capture(
        rng, 25, 50, (-32.0, 33.0, 16.0),
        {5: (16.0, 500.0), 34: (-16.0, 1200.0)}),
}


def _fields(r, L):
    return (r.prn, r.doppler, r.code_offset, r.align, r.linear,
            r.track_overlay_phase(L))


@pytest.mark.parametrize("name", sorted(CAPTURES))
def test_acquire_signal_coherent_matches_jax_fused(name, monkeypatch):
    monkeypatch.setenv("GNSS_DSP_PALLAS_INTERPRET", "1")
    from gnss_dsp_tpu.acquire import coherent as jcoh
    from gnss_dsp_tpu_torch.acquire import coherent as tcoh

    sig, x, prns, grid, ms = CAPTURES[name](np.random.default_rng(7))
    want = jcoh.acquire_signal_coherent(sig, x, prns, grid, ms=ms,
                                        engine="fused")
    got = tcoh.acquire_signal_coherent(sig, torch.from_numpy(x), prns, grid,
                                       ms=ms, engine="fused")
    L = sig.code_length
    assert [_fields(r, L) for r in got] == [_fields(r, L) for r in want]
    for a, b in zip(want, got):
        assert abs(b.metric - a.metric) <= 3e-2 * a.metric
    assert all(r.linear for r in got)        # B1I is pad2: 2n windows


def _l5i_case():
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq

    sig = dataclasses.replace(get_signal("gps-l5i"), acq_fs=12.288e6)
    prn = 25
    n = int(sig.acq_fs * 0.024)
    x = synth_iq(sig.code_table((prn,))[0], sig.chip_rate, sig.acq_fs, n,
                 doppler_hz=-40.0, code_phase=3333.0, cn0_dbhz=None,
                 carrier_ratio=sig.carrier_ratio,
                 data_bits=np.roll(sig.secondary(prn), 3))
    return sig, x, [prn], (-120.0, 121.0, 40.0), dict(ms=20)


def _no_secondary_case():
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq

    sig = dataclasses.replace(get_signal("gps-l1"), acq_fs=2.048e6)
    n = int(sig.acq_fs * 0.014)
    x = synth_iq(sig.code_table((7,))[0], sig.chip_rate, sig.acq_fs, n,
                 doppler_hz=30.0, code_phase=222.0, cn0_dbhz=None,
                 carrier_ratio=sig.carrier_ratio)
    return sig, x, [7], (-90.0, 91.0, 30.0), dict(m_coh=10, ms=10)


@pytest.mark.parametrize("case", [_l5i_case, _no_secondary_case],
                         ids=["l5i_nh10", "no_secondary"])
def test_xla_engine_matches_jax(case):
    from gnss_dsp_tpu.acquire import coherent as jcoh
    from gnss_dsp_tpu_torch.acquire import coherent as tcoh

    sig, x, prns, grid, kw = case()
    want = jcoh.acquire_signal_coherent(sig, x, prns, grid, engine="xla",
                                        **kw)
    got = tcoh.acquire_signal_coherent(sig, torch.from_numpy(x), prns, grid,
                                       engine="xla", **kw)
    L = sig.code_length
    assert [_fields(r, L) for r in got] == [_fields(r, L) for r in want]
    for a, b in zip(want, got):
        assert abs(b.metric - a.metric) <= 1e-4 * a.metric
        assert not b.linear


def test_fused_route_outside_the_kernels_is_refused_on_cuda(monkeypatch):
    """A fused window the CUDA kernels do not take raises, naming the
    signal and W, before any work (the device check is the tensor's):
    gps-l5i at 12.288 MHz routes to K6 ("blk") at 24576, which K6 (powers
    of two up to 16384) does not take (tests/test_coherent.py's shape)."""
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu_torch.acquire import coherent as tcoh
    from gnss_dsp_tpu_torch.acquire.plan import coh_plan

    class CudaLike:
        device = torch.device("cuda")

    sig = dataclasses.replace(get_signal("gps-l5i"), acq_fs=12.288e6)
    assert coh_plan(sig, 12288, 10, 10)[:2] == ("blk", 24576)
    with pytest.raises(NotImplementedError, match="gps-l5i.*24576"):
        tcoh.acquire_signal_coherent(sig, CudaLike(), [1], (-50, 50, 25))


def test_fused_engine_names_the_divisibility_blocker_first():
    """Per-PRN overlays AND m_coh % N != 0: the error names m_coh % N,
    the condition that gates every fused route (the JAX package's message
    names only the per-PRN one)."""
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu_torch.acquire import coherent as tcoh

    rngo = np.random.default_rng(3)
    ovls = {p: rngo.choice([-1, 1], 20).astype(np.int8) for p in (5, 34)}
    sig = dataclasses.replace(get_signal("beidou-b1i"),
                              secondary=lambda p: ovls[p])
    x = torch.zeros(int(sig.acq_fs * 0.02), dtype=torch.complex64)
    with pytest.raises(ValueError, match="m_coh % overlay_len"):
        tcoh.acquire_signal_coherent(sig, x, [5, 34], (-20, 21, 20),
                                     m_coh=7, engine="fused")


def test_short_capture_names_the_time_it_needs():
    """Galileo E1C's 25 linear windows of 2n reach one 4 ms code period
    past the 100 ms span: a capture of 102 ms (the CLI's --time 100 + 2)
    is refused with the samples it needs, before any work (the reference
    fails in its reshape)."""
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu_torch.acquire import coherent as tcoh

    sig = get_signal("galileo-e1c")
    x = torch.zeros(int(sig.acq_fs * 0.102), dtype=torch.complex64)
    with pytest.raises(ValueError, match="851968 samples.*one code period"):
        tcoh.acquire_signal_coherent(sig, x, [1], (-5, 6, 5), ms=100)


# ------------------------------------------------------------------ CLI

@pytest.mark.parametrize("signal,opts,exc", [
    ("gps-l1", ["--mesh", "2"], SystemExit),
    ("glonass-l1", ["--coherent", "8"], NotImplementedError)],
    ids=["mesh", "fdma_coherent"])
def test_cli_refuses_unported_modes(signal, opts, exc, tmp_path):
    """--mesh is not an option of the port (optparse exits); FDMA raises."""
    from gnss_dsp_tpu_torch.cli import acquire as tcli

    iq = tmp_path / "x.iq"
    iq.write_bytes(np.zeros(2 * 200_000, np.int8).tobytes())
    with pytest.raises(exc):
        tcli.main(signal, opts + [str(iq), "4096000", "0", "--device", "cpu"])


def _run(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(*args) == 0
    return out.getvalue()


def test_cli_coherent_matches_jax_cli(tmp_path, monkeypatch):
    from gnss_dsp_tpu.cli import acquire as jcli
    from gnss_dsp_tpu.models import get_signal
    from gnss_dsp_tpu.utils.synth import synth_iq, to_int8_iq
    from gnss_dsp_tpu_torch.cli import acquire as tcli

    fs = 4.096e6
    sig = get_signal("gps-l1")
    n = int(fs * 0.025)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in ((3, 1230.0, 211.6), (9, -480.0, 803.3)):
        x += synth_iq(sig.code_table((prn,))[0].astype(np.float64),
                      sig.chip_rate, fs, n, doppler_hz=dop, code_phase=cp,
                      cn0_dbhz=None, carrier_ratio=sig.carrier_ratio)
    path = tmp_path / "gps_l1.iq"
    path.write_bytes(to_int8_iq(x, scale=16.0))
    args = ["--prn", "3,9", "--doppler-search", "-1500,1500,62.5",
            "--time", "16", "--coherent", "8", str(path), str(fs), "0"]
    monkeypatch.setenv("GNSS_DSP_NO_COMPILE_CACHE", "1")
    monkeypatch.setenv("GNSS_DSP_CPU", "1")
    monkeypatch.setenv("GNSS_DSP_PALLAS_INTERPRET", "1")
    want = _run(jcli.main, "gps-l1", args).strip().splitlines()
    got = _run(tcli.main, "gps-l1", args + ["--device", "cpu"]
               ).strip().splitlines()
    assert len(got) == len(want) == 2
    for a, b in zip(want, got):
        fa, fb = a.split(), b.split()
        assert fb[:4] + fb[6:] == fa[:4] + fa[6:], (a, b)
        # the JAX CLI takes the TPU kernel (bf16 IDFT) in interpret mode
        assert abs(float(fb[5]) - float(fa[5])) <= 3e-2 * float(fa[5])
    rows = {int(r.split()[1]): float(r.split()[3]) for r in got}
    assert rows[3] == 1250.0 and rows[9] == -500.0
