# Frozen copy of gnss_dsp_tpu_torch/models/codes/lfsr.py at commit 196026d.
# Changed: imports point at gnssbench.reference.models.
"""Generic Fibonacci LFSR machinery for GNSS spreading-code construction.

Register convention (matches how GNSS ICDs draw the shift registers, and
the reference's list representation, e.g. gps/ca.py:76-80): the state is
bits x[0..nbits-1]; each step outputs x[nbits-1], computes the new bit as
XOR of the tap positions, and shifts it in at x[0].

The state is packed into a Python int (bit i == x[i]) so a step is two
shifts and a popcount — fast enough to build every table at import time
except the 5.11M-chip GLONASS P code, which callers should disk-cache.
"""

from __future__ import annotations

import numpy as np


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
    mask = (1 << nbits) - 1
    tapmask = 0
    for t in taps:
        tapmask |= 1 << t
    if out_taps is None:
        out_taps = (nbits - 1,)
    outmask = 0
    for t in out_taps:
        outmask |= 1 << t

    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        out[i] = (state & outmask).bit_count() & 1
        new = (state & tapmask).bit_count() & 1
        state = ((state << 1) | new) & mask
    return out


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
    Returns uint8 [R, n] in {0,1}.  ~n numpy ops regardless of R — this is
    what makes the 10230-chip x 63-PRN families build in milliseconds.
    """
    states = np.array(inits, dtype=np.uint64).copy()
    mask = np.uint64((1 << nbits) - 1)
    tapmask = np.uint64(sum(1 << t for t in taps))
    outmask = np.uint64(sum(1 << t for t in (out_taps or (nbits - 1,))))
    one = np.uint64(1)
    out = np.empty((len(states), n), dtype=np.uint8)
    for i in range(n):
        out[:, i] = np.bitwise_count(states & outmask).astype(np.uint8) & 1
        if i == reset_at:
            states[:] = np.uint64(reset_state)
        else:
            new = (np.bitwise_count(states & tapmask) & one).astype(np.uint64)
            states = ((states << one) | new) & mask
    return out


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
