"""K3's and K4's launch plan and order of summation on the CPU (no card,
no nvcc): ops/track_step.step_plan and rank_samples for every catalog
signal, and step_sums, a numpy emulation of csrc/track_step.cu's order of
summation, held bit for bit against the plain correlator on the family
captures of tests/test_torch_track_families.py.  tests/test_torch_cuda.py
holds the kernel bit for bit against step_sums on the card, so this
module imports nothing of JAX at its top.

Tolerances: the plan and the split are integer logic, exact.  The sums
bit for bit: every term is a float32 sample times a float32 factor, exact
in float64, so a sum in another order rounds to the same float32 but
within 2^-29 of a tie (the kernel's claim, which this pins on the family
captures).
"""

import numpy as np
import pytest

from gnss_dsp_tpu_torch.models.signal import all_signals
from gnss_dsp_tpu_torch.ops import track_step
from gnss_dsp_tpu_torch.track.driver import make_params

SIGNALS = sorted(all_signals())
CHANNELS = (1, 4, 8, 32, 64, 200)
# the family captures of tests/test_torch_track_families.py (_CASES)
FAMILIES = ("galileo-e1b", "glonass-l1-p", "gps-l1", "gps-l1cp", "gps-l2cl",
            "gps-l2cm")


def step_sums(terms, ptr, n, S):
    """The kernel's six float32 sums of one channel's block on S CTAs:
    thread j of a rank adds the terms of its slots j, j + THREADS, ... in
    order (a slot is a sample of the rank's tiles, rank_samples), warp
    shuffles fold each warp to lane 0 (shfl_down by 16, 8, 4, 2, 1), the
    CTA adds its warps in order, rank 0 adds the ranks in order; float32
    at the end.  terms float64 [6, >= n] (the block's samples), ptr the
    block's first sample."""
    T = track_step.THREADS
    total = np.zeros(6)
    for r in range(S):
        i = track_step.rank_samples(int(n), int(ptr), S, r)
        rows = -(-i.shape[0] // T)
        # a zero row first: each thread's sum starts at 0.0
        vals = np.zeros((6, (rows + 1) * T))
        used = np.nonzero(i >= 0)[0]
        vals[:, T + used] = terms[:, i[used]]
        acc = np.cumsum(vals.reshape(6, rows + 1, T), axis=1)[:, -1]
        v = acc.reshape(6, T // 32, 32)
        for o in (16, 8, 4, 2, 1):
            v = v.copy()
            v[..., :32 - o] = v[..., :32 - o] + v[..., o:]
        cta = np.zeros(6)
        for w in range(T // 32):
            cta = cta + v[:, w, 0]
        total = total + cta
    return total.astype(np.float32)


def _spans(sig):
    """The coherent spans a signal tracks at: 1, and the overlay's length
    where the signal has one."""
    if sig.secondary is None:
        return (1,)
    return (1, len(sig.secondary(sig.prns()[0])))


def _lengths(nmax, S):
    """Block lengths around the tile and cluster edges, and a sweep."""
    T = track_step.TILE
    edge = {1, 2, T - 1, T, T + 1, S * T - 1, S * T, S * T + 1, nmax // 2,
            nmax - 1, nmax}
    sweep = set(range(1, nmax + 1, max(1, nmax // 10)))
    return sorted(k for k in edge | sweep if 1 <= k <= nmax)


@pytest.mark.parametrize("name", SIGNALS)
def test_step_plan_every_catalog_signal(name):
    """S a power of two <= 16 with C x S <= 132 wherever C <= 132 (the
    largest such; 1 past 66 channels); and for every block length up to
    nmax and both parities of its start, every sample below n on exactly
    one rank, no rank with a tile past n, every rank with samples once
    n >= S x TILE, and no rank with more than its share of the tiles that
    nmax + 1 samples span."""
    sig = all_signals()[name]
    T = track_step.TILE
    for m in _spans(sig):
        nmax = make_params(sig, sig.acq_fs, 0.0, coherent_blocks=m).nmax
        sizes = set()
        for C in CHANNELS:
            p = track_step.step_plan(C)
            S = p["cluster"]
            sizes.add(S)
            assert 1 <= S <= 16 and S & (S - 1) == 0
            assert p["ctas"] == C * S
            assert C * S <= 132 or S == 1
            assert S == 16 or C * 2 * S > 132
        for S in sorted(sizes):
            tpc = -(-(-(-(nmax + 1) // T)) // S)
            for n in _lengths(nmax, S):
                for ptr in (40_000, 40_001):
                    seen = np.zeros(n, np.int64)
                    for r in range(S):
                        i = track_step.rank_samples(n, ptr, S, r)
                        assert i.shape[0] <= tpc * T
                        assert (i.reshape(-1, T) >= 0).any(axis=1).all()
                        if n >= S * T:
                            assert (i >= 0).any()
                        np.add.at(seen, i[i >= 0], 1)
                    assert (seen == 1).all(), (name, m, S, n, ptr)


def test_step_plan_override_and_refusals():
    assert track_step.step_plan(32)["cluster"] == 4
    assert track_step.step_plan(32)["ctas"] == 128
    assert track_step.step_plan(8)["cluster"] == 16
    assert track_step.step_plan(200)["cluster"] == 1
    assert track_step.step_plan(32, 1)["cluster"] == 1
    for bad in (0, 3, 32):
        with pytest.raises(ValueError):
            track_step.step_plan(8, bad)
    with pytest.raises(ValueError):
        track_step.step_plan(0)


@pytest.mark.parametrize("S", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", FAMILIES)
def test_step_order_matches_plain_bit_for_bit(name, S):
    """40 blocks of each family capture, stepped by the plain scan: K3's
    and K4's order of summation on S CTAs gives epl_correlate_plain's
    float32 sums exactly."""
    from test_torch_track_fused_plan import _blocks
    from test_torch_track_families import _CASES

    assert FAMILIES == tuple(sorted(_CASES))
    blocks = _blocks(name)
    assert sum(b[0].shape[0] for b in blocks) >= 40
    for terms, start, want, nmax, n in blocks:
        for c in range(terms.shape[0]):
            np.testing.assert_array_equal(
                step_sums(terms[c], start[c], n[c], S), want[c])
