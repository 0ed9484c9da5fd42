"""Kernel K1 (gnss_dsp_tpu_torch/csrc/acquire2.cu) emulated in numpy on
the CPU, index for index, at every window the acquisition plan sends it.

  * the plan: the core and cluster size of each window of the catalog
    (ops/acquire2.core_plan, which the card tests hold against the
    kernel's own acq2_info);
  * the register core (acq_cluster.cuh surface_rows, Split) at 4096,
    16384, 32768, 65536 and 81920 = 256 x 320 over each cluster size
    built, through test_torch_acquire_coh._split_transform: which rank and
    thread own which lag, the exchange and distributed-shared-memory
    transpose addresses, the two-table twiddle, the 320-point rows (20
    values a thread in step A, 16 in step C), and at (32768, 8) and
    (65536, 8) the code values a thread keeps in registers;
  * the run-time core (row_transform) at 163840 = 320 x 512 over 16 CTAs
    and the unpadded 61380, through test_torch_acquire_wide._cluster_ifft:
    the Stockham passes with the radix-5 step of 320 and the 512-point
    (16, 16, 2) sub-transform;
  * the kernel's reduction: each thread's lags in the order it sums them,
    the shuffle tree of each warp, the warps, then the ranks in order;
    (max, lowest lag, sum) with and without n_valid against
    corr_surface2_plain, and a tie across ranks to the lowest lag;
  * K5's reduction on the same cores (csrc/acquire_coh_spec.cu at every
    window the coherent route sends it): the per-lag fold over the
    alignments, then a tie across ranks and alignments to the lowest lag,
    then the lowest alignment;
  * K5's batched core at 16384 (coh_spec_kernel_batch): its plan, the
    walk of a cluster's rows with the fold at each alignment's last group
    and the alignment chunks' merge key, and the order of the cluster
    barriers that lets two yb buffers take one barrier a row.
"""

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.acquire.plan import acq_plan
from gnss_dsp_tpu_torch.models.signal import all_signals, get_signal
from gnss_dsp_tpu_torch.ops import acquire2
from test_torch_acquire_coh import _split, _split_index, _split_transform
from test_torch_acquire_wide import _cluster_ifft

# each window of the catalog: (core, n1, n2, cluster size)
WINDOWS = {4096: ("split", 64, 64, 2), 16384: ("split", 128, 128, 8),
           32768: ("split", 128, 256, 8), 65536: ("split", 256, 256, 8),
           81920: ("split", 256, 320, 16), 163840: ("wide", 320, 512, 16)}


def test_k1_plan_at_every_window_of_the_catalog():
    seen = set()
    for name in all_signals():
        route, W, _, _ = acq_plan(get_signal(name))
        if route != "v1":
            seen.add(W)
            assert acquire2.core_plan(W) == WINDOWS[W], name
    assert seen == set(WINDOWS)
    for W, built in acquire2.SPLIT_CLUSTERS.items():
        assert acquire2.core_plan(W)[3] == built[0]
        for C in built:
            assert acquire2.core_plan(W, C) == WINDOWS[W][:3] + (C,)
    # a cluster size not built there takes the run-time core
    assert acquire2.core_plan(81920, 8) == ("wide", 256, 320, 8)
    assert acquire2.core_plan(4096, 16) == ("wide", 64, 64, 16)
    with pytest.raises(NotImplementedError):
        acquire2.core_plan(7 * 13 * 64)     # no split
    with pytest.raises(NotImplementedError):
        acquire2.core_plan(81920, 4)        # its lags do not fit 4 CTAs
    with pytest.raises(NotImplementedError):
        acquire2.core_plan(163840, 32)      # clusters hold up to 16 CTAs


def _threads(W, cluster=0, plan=acquire2.core_plan):
    """The kernel's threads, [rank][tid] -> the lags the thread sums, in
    its order: the register core's row role (tid < TR: t2 = tid / NR, jl =
    tid mod NR, lag rank*NR + jl + n1*split_index(o, t2) for o < R2), the
    run-time core's row layout (element e = tid + i*384 < nr*n2 of rank r
    is lag r*nr + e div n2 + n1*(e mod n2)).  Also returns T.  `plan`:
    K1's core_plan, or K5's spec_core_plan."""
    core, n1, n2, C = plan(W, cluster)
    if core == "split":
        _, Q1, _, _, _ = _split(n1)
        _, Q2, _, RO2, QO2 = _split(n2)
        NC, NR = n2 // C, n1 // C
        T = max(NC * Q1, NR * Q2, NR * QO2, 32)
        return [[[r * NR + tid % NR + n1 * _split_index(n2, o, tid // NR)
                  for o in range(RO2)] if tid < NR * QO2 else []
                 for tid in range(T)] for r in range(C)], T
    T, per = acquire2.WIDE_THREADS, acquire2.WIDE_PER
    nr = -(-n1 // C)
    out = []
    for r in range(C):
        ea = min(nr, n1 - r * nr) * n2
        out.append([[r * nr + e // n2 + n1 * (e % n2)
                     for e in range(tid, ea, T)][:per] for tid in range(T)])
        assert all(len(range(tid, ea, T)) <= per for tid in range(T))
    return out, T


def _better(v, j, bv, bj):
    return v > bv or (v == bv and j < bj)


def _reduce(s, W, lo, cluster=0):
    """K1's reduction of the block-summed surface s [W] (float32) as the
    kernel orders it: (peak, lowest lag >= lo reaching it, sum over the
    lags >= lo), before the 1/W scale."""
    threads, T = _threads(W, cluster)
    f32 = np.float32
    ranks = []
    for lanes in threads:
        bests = []
        for lags in lanes:                     # each thread, in its order
            b = [f32(-np.inf), W, f32(0)]
            for j in lags:
                if j >= lo:
                    if _better(s[j], j, b[0], b[1]):
                        b[:2] = [s[j], j]
                    b[2] = f32(b[2] + s[j])
            bests.append(b)
        warps = []
        for w in range(T // 32):               # __shfl_down_sync tree
            lane = [list(b) for b in bests[32 * w:32 * w + 32]]
            for off in (16, 8, 4, 2, 1):
                old = [list(b) for b in lane]
                for i in range(32):
                    x = old[i + off] if i + off < 32 else old[i]
                    lane[i][2] = f32(old[i][2] + x[2])
                    if _better(x[0], x[1], lane[i][0], lane[i][1]):
                        lane[i][:2] = x[:2]
            warps.append(lane[0])
        c = list(warps[0])                     # the warps, then the ranks
        for o in warps[1:]:
            if _better(o[0], o[1], c[0], c[1]):
                c[:2] = o[:2]
            c[2] = f32(c[2] + o[2])
        ranks.append(c)
    c = list(ranks[0])
    for o in ranks[1:]:
        if _better(o[0], o[1], c[0], c[1]):
            c[:2] = o[:2]
        c[2] = f32(c[2] + o[2])
    return c


def _transform(X, W, cluster=0):
    """(x, owner): the unscaled inverse DFT of one row on K1's core, and
    the rank that produced each lag."""
    core, n1, n2, C = acquire2.core_plan(W, cluster)
    if core == "split":
        return _split_transform(X, n1, n2, C)
    return _cluster_ifft(X, n1, n2, C)


@pytest.mark.parametrize("W,C", [(4096, 2), (4096, 1), (4096, 4),
                                 (4096, 8), (16384, 8), (32768, 16),
                                 (32768, 8), (65536, 16), (65536, 8),
                                 (81920, 16)])
def test_k1_register_core_is_the_inverse_dft(W, C):
    """The register core at each build: the inverse DFT to float32
    twiddle rounding (2e-6 of the input's scale), rank r making the lags
    of rows j1 in [r*NR, (r+1)*NR), and each lag summed by exactly one
    thread of that rank; with the code in registers ((32768, 8),
    (65536, 8)) thread (t1, col) reads its code
    value m at the same element as the staged slice's
    (t1 + Q1 bitrev(m))*NC + col."""
    core, n1, n2, _ = acquire2.core_plan(W, C)
    assert core == "split"
    rng = np.random.default_rng(W + C)
    X = rng.standard_normal(W) + 1j * rng.standard_normal(W)
    x, owner = _transform(X, W, C)
    np.testing.assert_allclose(x / W, np.fft.ifft(X), rtol=0,
                               atol=2e-6 * np.abs(X).max())
    assert (owner == (np.arange(W) % n1) // (n1 // C)).all()
    threads, _ = _threads(W, C)
    lags = [j for r, lanes in enumerate(threads) for t in lanes for j in t
            if owner[j] == r]
    assert sorted(lags) == list(range(W))
    if W >= 32768 and C == 8:                 # kCodeRegs
        R1, Q1, _, _, _ = _split(n1)
        NC = n2 // C
        bits = R1.bit_length() - 1
        for t1 in range(Q1):
            for m in range(R1):
                br = int(format(m, f"0{bits}b")[::-1], 2)
                e = (t1 + Q1 * br) * NC + np.arange(NC)
                k1, c = e // NC, e % NC        # the staged slice's element
                assert (c + n2 * k1 == np.arange(NC) + n2 * (t1 + Q1 * br)
                        ).all()


@pytest.mark.parametrize("W", [163840, 61380])
def test_k1_runtime_core_is_the_inverse_dft(W):
    """The run-time core at 163840 (radix-5 step of the 320-point
    sub-transform, 512 = 16 x 16 x 2) and at the unpadded L5 window
    61380 = 220 x 279: the inverse DFT, and every lag summed by exactly
    one thread of the rank that made it."""
    core, n1, n2, C = acquire2.core_plan(W)
    assert core == "wide"
    rng = np.random.default_rng(W)
    X = rng.standard_normal(W) + 1j * rng.standard_normal(W)
    x, owner = _transform(X, W)
    np.testing.assert_allclose(x / W, np.fft.ifft(X), rtol=0,
                               atol=2e-6 * np.abs(X).max())
    threads, _ = _threads(W)
    lags = [j for r, lanes in enumerate(threads) for t in lanes for j in t
            if owner[j] == r]
    assert sorted(lags) == list(range(W))


def _emulate(F, code, n_valid, cluster=0):
    """K1 on [DC, B, W] spectra and [P, W] code spectra, emulated: each
    row transformed on its core, |.| summed over the blocks, reduced as
    the kernel orders it, scaled by 1/W."""
    DC, B, W = F.shape
    P = code.shape[0]
    lo = W - n_valid if n_valid else 0
    out = np.zeros((3, P, DC))
    for p in range(P):
        for d in range(DC):
            s = sum(np.abs(_transform(code[p] * np.conj(F[d, b]), W,
                                      cluster)[0]) for b in range(B))
            v, j, sm = _reduce(s.astype(np.float32), W, lo, cluster)
            out[:, p, d] = (v / W, j - lo, sm / W)
    return out


@pytest.mark.parametrize("W,n_valid,P,DC,B", [
    (4096, 0, 3, 2, 2), (16384, 0, 2, 2, 2), (32768, 15345, 2, 1, 2),
    (32768, 0, 1, 2, 1), (65536, 30690, 2, 1, 1), (65536, 0, 1, 1, 2),
    (81920, 0, 2, 1, 1), (163840, 0, 1, 1, 2)])
def test_k1_emulation_matches_the_plain_version(W, n_valid, P, DC, B):
    """The emulated kernel's (peak, lowest lag, sum) against
    corr_surface2_plain on planted spectra (PRN p at doppler p mod DC and
    a lag among the searched ones): lags exact, peak and sum rtol 1e-5."""
    rng = np.random.default_rng(W + n_valid)
    lo = W - n_valid if n_valid else 0
    code = np.exp(2j * np.pi * rng.random((P, W)))
    F = rng.standard_normal((DC, B, W)) + 1j * rng.standard_normal((DC, B, W))
    k = np.arange(W)
    lags = lo + rng.integers(0, W - lo, P)
    for p in range(P):
        F[p % DC] += code[p] * np.exp(2j * np.pi * k * lags[p] / W)
    got = _emulate(F, code, n_valid)
    peak, idx, sm = (v.numpy() for v in acquire2.corr_surface2_plain(
        torch.from_numpy(F.astype(np.complex64)),
        torch.from_numpy(code.astype(np.complex64)), n_valid))
    for p in range(P):
        assert int(got[1, p, p % DC]) == int(idx[p, p % DC]) == lags[p] - lo
    np.testing.assert_array_equal(got[1], idx)
    np.testing.assert_allclose(got[0], peak, rtol=1e-5)
    np.testing.assert_allclose(got[2], sm, rtol=1e-5)


@pytest.mark.parametrize("W", sorted(WINDOWS))
def test_k1_reduction_takes_the_lowest_of_tied_lags_across_ranks(W):
    """A surface whose maximum ties at a lag of rank 0 and a lag of the
    last rank, the lower lag in either rank: the reduction reports the
    lower lag, searched from 0 and from just below it, and sums every
    searched lag."""
    core, n1, n2, C = acquire2.core_plan(W)
    nr = -(-n1 // C)
    last = (C - 1) * nr                       # the first row of the last rank
    for a, b in ((1, last + n1), (last, n1 + 1)):   # rank 0, last rank
        s = np.full(W, 0.25, np.float32)
        s[a] = s[b] = 2.0
        for lo in (0, min(a, b) - 1):
            v, j, sm = _reduce(s, W, lo)
            assert (v, j) == (2.0, min(a, b))
            np.testing.assert_allclose(sm, s[lo:].sum(dtype=np.float64),
                                       rtol=1e-6)


def _reduce_k5(q, W, lo):
    """K5's reduction of the alignment surfaces q [A, W] (float32) as the
    kernel orders it on either core: per lag the best over the alignments
    walked in ascending order (a strict >: the lowest alignment on ties),
    then (peak, lowest lag >= lo reaching it, its alignment) over each
    thread's lags, the shuffle tree of each warp, the warps, the ranks."""
    A = q.shape[0]
    best, besta = q[0].copy(), np.zeros(W, int)
    for a in range(1, A):
        up = q[a] > best
        best[up], besta[up] = q[a][up], a
    return _reduce_best(best, besta, W, lo)


def _reduce_best(best, besta, W, lo):
    """K5's reduction of the per-lag (best, alignment) as the kernel
    orders it: (peak, lowest lag >= lo reaching it, its alignment) over
    each thread's lags, the shuffle tree of each warp, the warps, the
    ranks."""
    from gnss_dsp_tpu_torch.ops.acquire_coh import spec_core_plan

    threads, T = _threads(W, plan=spec_core_plan)

    def take(c, o):
        return list(o) if _better(o[0], o[1], c[0], c[1]) else c

    ranks = []
    for lanes in threads:
        bests = []
        for lags in lanes:
            b = [np.float32(-np.inf), W, 0]
            for j in lags:
                if j >= lo and _better(best[j], j, b[0], b[1]):
                    b = [best[j], j, besta[j]]
            bests.append(b)
        warps = []
        for w in range(T // 32):
            lane = [list(b) for b in bests[32 * w:32 * w + 32]]
            for off in (16, 8, 4, 2, 1):
                old = [list(b) for b in lane]
                lane = [take(old[i], old[i + off] if i + off < 32 else old[i])
                        for i in range(32)]
            warps.append(lane[0])
        c = warps[0]
        for o in warps[1:]:
            c = take(c, o)
        ranks.append(c)
    c = ranks[0]
    for o in ranks[1:]:
        c = take(c, o)
    return c


@pytest.mark.parametrize("W", [16384, 32768, 65536, 81920, 163840])
def test_k5_reduction_takes_the_lowest_lag_then_alignment(W):
    """K5's reduction (ops/acquire_coh.spec_core_plan's core at each
    window the coherent route sends it, csrc/acquire_coh_spec.cu) on
    alignment surfaces that tie: alignments 1 and 2 equal at a lag of
    rank 0 and one of the last rank, alignment 0 lower there; searched
    from 0 and from just below the lower lag it reports the lower lag at
    alignment 1.  A higher value at a higher alignment and lag wins; a
    still higher one below lo loses."""
    from gnss_dsp_tpu_torch.ops.acquire_coh import spec_core_plan

    _, n1, n2, C = spec_core_plan(W)
    nr = -(-n1 // C)
    last = (C - 1) * nr                       # the first row of the last rank
    for a_lag, b_lag in ((1, last + n1), (last, n1 + 1)):
        q = np.full((3, W), 0.25, np.float32)
        q[1:, [a_lag, b_lag]] = 2.0
        q[0, [a_lag, b_lag]] = 1.0
        for lo in (0, min(a_lag, b_lag) - 1):
            assert _reduce_k5(q, W, lo) == [2.0, min(a_lag, b_lag), 1]
        q[2, W - 5] = 3.0
        q[0, 7] = 4.0
        assert _reduce_k5(q, W, 8) == [3.0, W - 5, 2]


# ---- K5's batched core at 16384 ----------------------------------------

def test_k5_batched_core_plan():
    """The batched core takes K5 at BATCHED_W = 16384 on 8 CTAs, the split
    core's 128 x 128 layout (its threads and lags are surface_rows' there);
    4 CTAs take the run-time core."""
    from gnss_dsp_tpu_torch.ops.acquire_coh import (
        BATCHED_W, SPEC_CLUSTERS, spec_core_plan)

    assert BATCHED_W == 16384 and SPEC_CLUSTERS[BATCHED_W] == (8,)
    assert spec_core_plan(BATCHED_W) == ("split", 128, 128, 8)
    assert spec_core_plan(BATCHED_W, 8) == ("split", 128, 128, 8)
    assert spec_core_plan(BATCHED_W, 4)[0] == "wide"


def _walk_k5(rows, G, A, a0, a1):
    """The batched core's walk of one cluster over the per-row |x|
    surfaces rows [G*A, W] (float32, row g*A + a): alignments [a0, a1),
    their G groups in order; acc sums each row as it comes and folds at an
    alignment's last group into the per-lag (best, lowest alignment), the
    alignments ascending.  Returns (best, besta)."""
    W = rows.shape[1]
    acc = np.zeros(W, np.float32)
    best, besta = np.full(W, -np.inf, np.float32), np.zeros(W, int)
    for a in range(a0, a1):
        for g in range(G):
            acc = (acc + rows[g * A + a]).astype(np.float32)
        up = acc > best
        best[up], besta[up] = acc[up], a
        acc = np.zeros(W, np.float32)
    return best, besta


def _key(v, j, a, lo):
    """merge_chunk's 64-bit key of one chunk's (peak, lag, alignment)."""
    return (int(np.float32(v).view(np.uint32)) << 32
            | (16383 - (j - lo)) << 16 | (65535 - a))


@pytest.mark.parametrize("G,A,a_chunk", [
    (2, 20, 20), (1, 3, 3), (3, 3, 3), (10, 1, 1), (2, 3, 2), (3, 5, 2),
    (1, 5, 1)])
def test_k5_batched_walk_folds_each_alignment(G, A, a_chunk):
    """The batched core's walk gives the per-lag (best, alignment) of the
    alignment surfaces summed over the groups, and K5's reduction of it
    (on the batched core's threads) the plain finalize_max's (peak, lag,
    alignment); split into alignment chunks of a_chunk, the highest merge
    key decodes to the same cell.  The rows hold ties: alignments 1 and 2
    equal, so the walk must keep alignment 1."""
    W, lo = 16384, 0
    rng = np.random.default_rng(G * 100 + A * 10 + a_chunk)
    rows = rng.random((G * A, W)).astype(np.float32)
    if A >= 3:
        rows[2::A] = rows[1::A]
    q = np.zeros((A, W), np.float32)
    for a in range(A):
        for g in range(G):
            q[a] = (q[a] + rows[g * A + a]).astype(np.float32)
    best, al = _walk_k5(rows, G, A, 0, A)
    assert np.array_equal(best, q.max(0)) and np.array_equal(al, q.argmax(0))
    got = _reduce_k5(q, W, lo)
    assert _reduce_best(best, al, W, lo) == got
    j = int(np.argmax(q.max(0)))
    assert got == [q.max(), j, int(q.argmax(0)[j])]
    if A >= 3:
        assert not (al == 2).any()
    keys = []
    for c0 in range(0, A, a_chunk):
        b, ba = _walk_k5(rows, G, A, c0, min(A, c0 + a_chunk))
        jj = int(np.argmax(b))
        keys.append(_key(b[jj], jj, int(ba[jj]), lo))
    w = max(keys)
    assert ((w >> 32), 16383 - ((w >> 16) & 0xffff), 65535 - (w & 0xffff)) \
        == (int(np.float32(got[0]).view(np.uint32)), got[1], got[2])


def test_k5_batched_reduction_takes_the_lowest_lag_then_alignment():
    """The planted ties of test_k5_reduction_takes_the_lowest_lag_then_
    alignment walked by the batched core at 16384 (G = 1, A = 3), then
    reduced on its threads: the lower lag across ranks, then alignment
    1."""
    from gnss_dsp_tpu_torch.ops.acquire_coh import BATCHED_W, spec_core_plan

    W = BATCHED_W
    _, n1, n2, C = spec_core_plan(W)
    nr = -(-n1 // C)
    last = (C - 1) * nr
    for a_lag, b_lag in ((1, last + n1), (last, n1 + 1)):
        per_row = np.full((3, W), 0.25, np.float32)
        per_row[1:, [a_lag, b_lag]] = 2.0
        per_row[0, [a_lag, b_lag]] = 1.0
        best, al = _walk_k5(per_row, 1, 3, 0, 3)
        for lo in (0, min(a_lag, b_lag) - 1):
            assert _reduce_best(best, al, W, lo) == \
                [2.0, min(a_lag, b_lag), 1]


def _barrier_hazards(n_ctas, n_rows, bufs, barriers, seed):
    """The yb protocol of a cluster of n_ctas CTAs under a random
    schedule: row i writes each CTA's yb buffer i mod bufs, arrives at the
    cluster barrier, waits for every CTA's arrival there, then reads every
    CTA's buffer i mod bufs; with two barriers a row (surface_rows' order)
    a CTA also arrives after its reads and waits for that arrival of every
    CTA before its next write.  A wait passes once every CTA has made as
    many arrivals.  Returns the writes that found a reader of the buffer's
    last row not yet done: (writer, row, reader)."""
    rng = np.random.default_rng(seed)
    prog = []
    for i in range(n_rows):
        if barriers == 2 and i:
            prog.append(("wait",))
        prog += [("write", i), ("arrive",), ("wait",), ("read", i)]
        if barriers == 2:
            prog.append(("arrive",))
    pc, arrived, waited = [0] * n_ctas, [0] * n_ctas, [0] * n_ctas
    read = [[-1] * n_ctas for _ in range(n_ctas)]   # [reader][owner]
    hazards = []
    while min(pc) < len(prog):
        ready = [c for c in range(n_ctas) if pc[c] < len(prog) and not (
            prog[pc[c]][0] == "wait" and min(arrived) <= waited[c])]
        c = int(rng.choice(ready))
        op = prog[pc[c]]
        if op[0] == "write":
            hazards += [(c, op[1], q) for q in range(n_ctas)
                        if op[1] >= bufs and read[q][c] < op[1] - bufs]
        elif op[0] == "arrive":
            arrived[c] += 1
        elif op[0] == "wait":
            waited[c] += 1
        else:
            for r in range(n_ctas):
                read[c][r] = op[1]
        pc[c] += 1
    return hazards


@pytest.mark.parametrize("seed", range(6))
def test_k5_two_yb_buffers_need_one_barrier_a_row(seed):
    """Under random schedules of 8 CTAs over 12 rows no CTA writes a yb
    buffer before every reader of its last row there is done: two buffers
    and one cluster barrier a row (the batched core), one buffer and two
    (surface_rows, the ablation).  One buffer with one barrier a row loses
    reads, and the check sees it."""
    assert _barrier_hazards(8, 12, 2, 1, seed) == []
    assert _barrier_hazards(8, 12, 1, 2, seed) == []
    assert any(_barrier_hazards(8, 12, 1, 1, seed * 20 + s)
               for s in range(20))
