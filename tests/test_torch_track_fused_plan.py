"""K2's cluster plan and the arithmetic its redesign rests on, on the CPU
(no card, no nvcc): ops/track_fused.cluster_plan for every catalog
signal, the chip-index range that lets the per-sample body wrap by
compares (csrc/track_corr.cuh compare_wrap_ok, wrap_chip), and a CPU
emulation of the kernel's S-way split sums against the plain correlator.

Tolerances: the plan and the wrap are integer logic, exact.  The split
sums are held bit for bit against ops/track_step.epl_correlate_plain:
every term is a float32 sample times a float32 factor, exact in float64,
so a sum in another order rounds to the same float32 but within 2^-29 of
a tie (the kernel's claim, which this pins on the family captures).
"""

import functools

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch import interop
from gnss_dsp_tpu_torch.models.signal import all_signals
from gnss_dsp_tpu_torch.ops import track_fused, track_step
from gnss_dsp_tpu_torch.track import engine as teng
from gnss_dsp_tpu_torch.track.driver import make_params
from test_torch_track_families import _CASES, _setup

SIGNALS = sorted(all_signals())
CHANNELS = (1, 4, 6, 8, 32, 64, 200)


def _window_positions(plan, rank, batch):
    """The window positions (samples from the even sample below a
    block's start) that stage-buffer slots 0, 1, ... of CTA `rank` hold in
    `batch`, -1 past the window: csrc/track_fused.cu's dealing, tile t on
    rank t % S, a CTA's tiles in order, k a batch."""
    S, k, tiles, T = (plan["cluster"], plan["k"], plan["tiles"],
                      track_fused.TILE)
    e = np.arange(k * T)
    t = rank + S * (batch * k + e // T)
    return np.where(t < tiles, t * T + e % T, -1)


def _spans(sig):
    """The coherent spans K2 may run a signal at: 1, and the overlay's
    length where the signal has one."""
    if sig.secondary is None:
        return (1,)
    return (1, len(sig.secondary(sig.prns()[0])))


@pytest.mark.parametrize("name", SIGNALS)
def test_cluster_plan_every_catalog_signal(name):
    """S a power of two <= 16 with C x S <= 132 wherever C <= 132 (the
    largest such), both stage buffers and the fixed part within 227 KB,
    and the dealing covers each window sample exactly once."""
    sig = all_signals()[name]
    for m in _spans(sig):
        nmax = make_params(sig, sig.acq_fs, 0.0, coherent_blocks=m).nmax
        for C in CHANNELS:
            p = track_fused.cluster_plan(C, nmax)
            S = p["cluster"]
            assert 1 <= S <= 16 and S & (S - 1) == 0
            if C <= 132:
                assert C * S <= 132 and (S == 16 or C * 2 * S > 132)
            else:
                assert S == 1
            assert p["smem"] <= 227 * 1024
            assert p["smem"] == track_fused.FIXED_BYTES + 2 * p["stage_bytes"]
            assert p["k"] * p["batches"] >= p["tpc"]
            assert (p["batches"] == 1) == (p["k"] == p["tpc"])
            seen = np.zeros(p["tiles"] * track_fused.TILE, np.int64)
            for r in range(S):
                for q in range(p["batches"]):
                    pos = _window_positions(p, r, q)
                    np.add.at(seen, pos[pos >= 0], 1)
            assert (seen == 1).all()
            assert seen.shape[0] >= nmax + 2


@pytest.mark.parametrize("nmax", [3076, 6148, 12292, 24556, 46039])
def test_sample_loop_bound_keeps_every_sample(nmax):
    """The kernel's sample loop stops each rank at slot e1 = (mine - q k)
    TILE, mine its tiles among the ceil((nloop + off) / TILE) that hold
    samples below nloop: no slot past it holds one, for every block
    length, start parity, rank and batch."""
    for S in (1, 2, 4, 8, 16):
        p = track_fused.cluster_plan(1, nmax, S)
        for nloop in range(1, nmax + 1, 193):
            for off in (0, 1):
                need = -(-(nloop + off) // track_fused.TILE)
                for r in range(S):
                    mine = -(-(need - r) // S) if need > r else 0
                    for q in range(p["batches"]):
                        pos = _window_positions(p, r, q)
                        s = pos - off
                        used = (pos >= 0) & (s >= 0) & (s < nloop)
                        e1 = min(pos.shape[0], max(
                            0, (mine - q * p["k"]) * track_fused.TILE))
                        assert not used[e1:].any()
                        assert (pos[:e1] >= 0).all()


def test_cluster_plan_override_and_refusals():
    assert track_fused.cluster_plan(32, 6148, 1)["cluster"] == 1
    assert track_fused.cluster_plan(32, 6148, 16)["cluster"] == 16
    for bad in (0, 3, 32):
        with pytest.raises(ValueError):
            track_fused.cluster_plan(8, 6148, bad)
    with pytest.raises(ValueError):
        track_fused.cluster_plan(8, 0)


# the per-sample body's chip-index arithmetic (csrc/track_corr.cuh)
def _compare_wrap_ok(vint, fr, cf, n, L):
    """compare_wrap_ok: every vint + floor(fma(i, cf, fr)), 0 <= i < n,
    in [-L, 3L) (the fma as the plain version rounds it)."""
    last = np.float32(np.float64(n - 1) * np.float64(cf) + np.float64(fr))
    a = vint + int(np.floor(np.float32(fr)))
    z = vint + int(np.floor(last))
    return min(a, z) >= -L and max(a, z) < 3 * L


def _wrap_chip(c, L):
    """wrap_chip with cmp set, over an int64 array."""
    c = np.where(c < 0, c + L, c)
    c = np.where(c >= L, c - L, c)
    return np.where(c >= L, c - L, c)


@pytest.mark.parametrize("name", SIGNALS)
def test_chip_index_range_allows_the_compare_wrap(name):
    """At the worst geometry the tracking loop can give a block (vint at
    -1 and L: the early lag at code phase ~0, the late lag just under L;
    fr from just below 0 to 1; cf 0.1% above and below the nominal rate,
    far past any doppler; i up to nmax - 1), every chip index lies in
    [-L, 3L), and there the compare wrap equals torch.remainder."""
    sig = all_signals()[name]
    L = int(sig.code_length)
    p = make_params(sig, sig.acq_fs, 0.0)
    nmax = p.nmax
    lo, hi = None, None
    for cf in (np.float32(p.cf_hi * 0.999), np.float32(p.cf_hi * 1.001)):
        for vint in (-1, L):
            for fr in (np.float32(-2.0 ** -24), np.float32(0.0),
                       np.float32(1.0)):
                assert _compare_wrap_ok(vint, fr, cf, nmax, L), (vint, fr, cf)
                i = np.arange(nmax, dtype=np.float64)
                cp = (i * np.float64(cf) + np.float64(fr)).astype(np.float32)
                chip = vint + np.floor(cp).astype(np.int64)
                lo = chip.min() if lo is None else min(lo, chip.min())
                hi = chip.max() if hi is None else max(hi, chip.max())
    assert -L <= lo and hi < 3 * L
    if L > 10 ** 7:           # gps-p: no code table; the range holds
        return
    c = np.arange(lo, hi + 1, dtype=np.int64)
    np.testing.assert_array_equal(
        _wrap_chip(c, L), torch.remainder(torch.from_numpy(c), L).numpy())


# ---- the kernel's summation order, emulated
def _split_sums(terms, start, nmax, S):
    """K2's six sums for one block on S CTAs a channel: each CTA's
    threads add the terms of their stage slots in slot order (slot e of a
    batch to thread e % THREADS), warp shuffles fold each warp to lane 0
    (shfl_down by 16, 8, 4, 2, 1), the CTA adds its warps in order, and
    every CTA adds the S partials in rank order; float32 at the end.
    terms float64 [C, 6, nmax], start int [C] (the window start)."""
    p = track_fused.cluster_plan(1, nmax, S)
    T = track_fused.THREADS
    C = terms.shape[0]
    out = np.zeros((C, 6), np.float32)
    for c in range(C):
        off = int(start[c]) & 1
        total = np.zeros(6)
        for r in range(S):
            acc = np.zeros((6, T))
            for q in range(p["batches"]):
                pos = _window_positions(p, r, q)
                i = pos - off
                use = (pos >= 0) & (i >= 0) & (i < nmax)
                vals = np.zeros((6, -(-pos.shape[0] // T) * T))
                vals[:, np.nonzero(use)[0]] = terms[c][:, i[use]]
                for row in vals.reshape(6, -1, T).transpose(1, 0, 2):
                    acc = acc + row
            cta = np.zeros(6)
            for w in range(T // 32):
                v = acc[:, 32 * w: 32 * w + 32].copy()
                for o in (16, 8, 4, 2, 1):
                    v[:, :32 - o] = v[:, :32 - o] + v[:, o:]
                cta = cta + v[:, 0]
            total = total + cta
        out[c] = total.astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _blocks(name, nb=40):
    """(terms, window start, plain sums, nmax, n) of each ok block of the
    plain per-step scan on the family capture `name`."""
    s = _setup(name, pallas=False)
    p = interop.params_from_jax(s["params"])
    x = torch.from_numpy(s["xp"])
    code = torch.from_numpy(s["code"])
    st = interop.state_from_numpy(s["st"])
    C = s["C"]
    chunk = torch.full((C,), s["n"], dtype=torch.int32)
    ratios = torch.from_numpy(s["ratios"])
    cdf = torch.from_numpy(s["cdf"])
    sigp = torch.from_numpy(s["sigp"]).to(torch.float32)
    kind = track_step.subc_kind(p.subcarrier)
    out = []
    for _ in range(nb):
        si, sf, n, sj, nfull, ok, cf_dyn = teng._geometry(
            x.shape[0], chunk, ratios, st, p, cdf, sigp)
        terms = torch.stack(track_step._epl_terms(si, sf, x, code, p.nmax,
                                                  kind, False), dim=1)
        want = track_step.epl_correlate_plain(si, sf, x, code, p.nmax, kind)
        keep = ok.numpy()
        out.append((terms.numpy()[keep], si[:, track_step.SI_PTR].numpy()[keep],
                    want.numpy()[keep], p.nmax,
                    si[:, track_step.SI_N].numpy()[keep]))
        pe, pp, pl = ((want[:, k], want[:, k + 1]) for k in (0, 2, 4))
        st, _, _ = teng._post_block(pe, pp, pl, n, sj, nfull, ok, cf_dyn, st,
                                    p, cdf, sigp)
    return out


@pytest.mark.parametrize("S", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_split_sums_match_plain_bit_for_bit(name, S):
    """40 blocks of each family capture (tests/test_torch_track_families.py),
    stepped by the plain scan: K2's order of summation on S CTAs gives
    epl_correlate_plain's float32 sums exactly."""
    blocks = _blocks(name)
    assert sum(b[0].shape[0] for b in blocks) >= 40
    for terms, start, want, nmax, _ in blocks:
        got = _split_sums(terms, start, nmax, S)
        np.testing.assert_array_equal(got, want)
