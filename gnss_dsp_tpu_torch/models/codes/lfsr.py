"""Generic Fibonacci LFSR machinery for GNSS spreading-code construction.

Register convention (matches how GNSS ICDs draw the shift registers, and
the reference's list representation, e.g. gps/ca.py:76-80): the state is
bits x[0..nbits-1]; each step outputs x[nbits-1], computes the new bit as
XOR of the tap positions, and shifts it in at x[0].

`lfsr_seq_batch` (and `lfsr_seq`, its one-register case) steps only the
first nbits chips, one numpy operation a chip.  The output of a Fibonacci
register is a linear function of its state, so it obeys the register's
characteristic recurrence o[m] = XOR_{t in taps} o[m-1-t] for m >= nbits,
whatever the output taps; and since p(x)^(2^k) = p(x^(2^k)) over GF(2),
o[m] = XOR_t o[m - 2^k (1+t)] for m >= nbits 2^k.  The rest is written
2^k (1 + min(taps)) chips of every row an operation, k rising by one
each time the written prefix doubles: at most nbits log2(n / nbits)
blocks in all, so a 10230-chip table of 64 rows, or the 5.11M-chip
GLONASS P code, builds in milliseconds.  Counters `codes.lfsr.chips`
and `codes.lfsr.chips_stepped` (utils/profiling) count the chips built
and those the per-chip loop wrote, inside span `codes.lfsr`.
"""

from __future__ import annotations

import numpy as np

from gnss_dsp_tpu_torch.utils import profiling


def bits_to_int(bits) -> int:
    """bits[i] -> bit i of the packed state."""
    v = 0
    for i, b in enumerate(bits):
        v |= (int(b) & 1) << i
    return v


def int_to_bits(v: int, nbits: int) -> list[int]:
    return [(v >> i) & 1 for i in range(nbits)]


def lfsr_seq(nbits: int, taps, init, n: int, out_taps=None) -> np.ndarray:
    """Run a Fibonacci LFSR for n steps.

    taps     : feedback tap positions (new bit = XOR of x[t] for t in taps)
    init     : initial state — iterable of bits (x[0]..x[nbits-1]) or packed int
    out_taps : output positions XORed to form each output bit
               (default: [nbits-1], the register's last stage)
    Returns uint8 [n] in {0,1}.
    """
    state = init if isinstance(init, int) else bits_to_int(init)
    return lfsr_seq_batch(nbits, taps, [state], n, out_taps=out_taps)[0]


def lfsr_stages(nbits: int, taps, init, n: int) -> np.ndarray:
    """Every stage of one register over n steps: uint8 [nbits, n], row j
    the bit x[j] before each step, so the output of any output taps is
    the XOR of their rows.  A shift moves x[j-1] to x[j], so row j is
    row 0 delayed j steps, preceded by the seed's x[j..1]."""
    bits = int_to_bits(init, nbits) if isinstance(init, int) else list(init)
    x0 = lfsr_seq(nbits, taps, bits, n, out_taps=(0,))
    ext = np.concatenate([np.array(bits[:0:-1], np.uint8), x0])
    idx = np.arange(nbits - 1, -1, -1)[:, None] + np.arange(n)[None, :]
    return ext[idx]


def lfsr_end_state(nbits: int, taps, init, n: int) -> int:
    """Packed register state after n steps (for ICD end-state test vectors,
    e.g. gps/l2cm.py:95-133)."""
    state = init if isinstance(init, int) else bits_to_int(init)
    mask = (1 << nbits) - 1
    tapmask = 0
    for t in taps:
        tapmask |= 1 << t
    for _ in range(n):
        new = (state & tapmask).bit_count() & 1
        state = ((state << 1) | new) & mask
    return state


def mseq(nbits: int, taps, init=None, n=None) -> np.ndarray:
    """Maximal-length sequence of period 2^nbits - 1 (GLONASS families)."""
    if init is None:
        init = (1 << nbits) - 1
    if n is None:
        n = (1 << nbits) - 1
    return lfsr_seq(nbits, taps, init, n)


def lfsr_seq_batch(nbits: int, taps, inits, n: int, out_taps=None,
                   reset_at: int = -1, reset_state=None) -> np.ndarray:
    """Run many Fibonacci LFSRs in lockstep, vectorized over registers.

    inits     : int64 [R] packed initial states (bit i == x[i])
    reset_at  : if >= 0, at step i == reset_at the register reloads
                `reset_state` INSTEAD of shifting (the BeiDou B2a/B2b
                G1 restart at chip 8189, b2ad.py:55-58)
    Returns uint8 [R, n] in {0,1}.  A reset splits the run in two: chips
    0..reset_at from `inits`, the rest from `reset_state`, the same for
    every row; each part follows its own recurrence.
    """
    out_taps = out_taps or (nbits - 1,)
    with profiling.span("codes.lfsr"):
        states = np.array(inits, dtype=np.uint64)
        out = np.empty((len(states), n), dtype=np.uint8)
        if 0 <= reset_at < n - 1:
            head, tail = out[:, :reset_at + 1], out[:, reset_at + 1:]
            stepped = _generate(nbits, taps, states, head, out_taps)
            stepped += _generate(nbits, taps,
                                 np.array([reset_state], np.uint64),
                                 tail[:1], out_taps)
            tail[1:] = tail[:1]
        else:
            stepped = _generate(nbits, taps, states, out, out_taps)
        profiling.count("codes.lfsr.chips", out.size)
        profiling.count("codes.lfsr.chips_stepped", stepped)
    return out


def _generate(nbits: int, taps, states, out, out_taps) -> int:
    """Write out[R, n] from the packed states [R]: the first nbits chips
    stepped a chip at a time, the rest by the doubling recurrence of the
    module docstring.  Returns the chips the per-chip loop wrote."""
    n = out.shape[1]
    mask = np.uint64((1 << nbits) - 1)
    tapmask = np.uint64(sum(1 << t for t in taps))
    outmask = np.uint64(sum(1 << t for t in out_taps))
    one = np.uint64(1)
    prefix = min(n, nbits)
    for i in range(prefix):
        out[:, i] = np.bitwise_count(states & outmask).astype(np.uint8) & 1
        new = (np.bitwise_count(states & tapmask) & one).astype(np.uint64)
        states = ((states << one) | new) & mask
    lags = [1 + t for t in taps]
    m, stride = prefix, 1
    while m < n:
        if m >= 2 * stride * nbits:
            stride *= 2
        # every source lies at least stride * min(lags) chips back
        w = min(stride * min(lags), n - m)
        first, *rest = (m - stride * lag for lag in lags)
        dst = out[:, m:m + w]
        dst[...] = out[:, first:first + w]
        for a in rest:
            dst ^= out[:, a:a + w]
        m += w
    return out.shape[0] * prefix


def galois_seq_batch(nbits: int, poly: int, inits, n: int) -> np.ndarray:
    """Batched Galois-form LFSR x -> (x>>1) ^ lsb(x)*poly, output = lsb —
    the GPS L2C 27-stage generator (l2cm.py:46-56).  uint8 [R, n]."""
    states = np.array(inits, dtype=np.uint64).copy()
    p = np.uint64(poly)
    one = np.uint64(1)
    out = np.empty((len(states), n), dtype=np.uint8)
    for i in range(n):
        lsb = states & one
        out[:, i] = lsb.astype(np.uint8)
        states = (states >> one) ^ (lsb * p)
    return out


def bits_from_str(s: str) -> list[int]:
    return [1 if c == "1" else 0 for c in s]


def xor_pm1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """{0,1} XOR of two chip streams, returned as int8 {-1,+1} (0 -> +1)."""
    return (1 - 2 * (a.astype(np.int8) ^ b.astype(np.int8))).astype(np.int8)


def to_pm1(a: np.ndarray) -> np.ndarray:
    """{0,1} -> {+1,-1} int8 (chip 0 maps to +1, matching 1-2c)."""
    return (1 - 2 * a.astype(np.int8)).astype(np.int8)
