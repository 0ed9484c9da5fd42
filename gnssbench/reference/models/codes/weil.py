# Frozen copy of gnss_dsp_tpu_torch/models/codes/weil.py at commit 196026d.
# Changed: imports point at gnssbench.reference.models.
"""Weil-code machinery (GPS L1C, BeiDou B1C/B2a secondaries).

A Weil code of prime length N is W_w[k] = L[k] xor L[(k+w) mod N], where
L is the Legendre indicator (L[k]=1 iff k is a nonzero quadratic residue
mod N; L[0]=0).  The reference computes L with sympy.legendre_symbol one
value at a time (gps/l1cp.py:67-70); here the whole indicator is one
vectorized squaring pass — the QR set of a prime is exactly
{k^2 mod N : 1 <= k < N}.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=8)
def legendre_bits(N: int) -> np.ndarray:
    """uint8 [N]; 1 where k is a nonzero QR mod N, else 0 (L[0] = 0)."""
    k = np.arange(1, N, dtype=np.int64)
    qr = (k * k) % N
    L = np.zeros(N, dtype=np.uint8)
    L[qr] = 1
    return L


def weil(N: int, w: int) -> np.ndarray:
    L = legendre_bits(N)
    return L ^ np.roll(L, -w)


def weil_insert(N: int, w: int, p: int, expansion, total: int) -> np.ndarray:
    """GPS L1C form (l1cp.py:72-77): splice a 7-chip expansion into the
    Weil sequence at insertion point p (1-based)."""
    W = weil(N, w)
    e = np.asarray(expansion, dtype=np.uint8)
    return np.concatenate([W[: p - 1], e, W[p - 1:]])[:total]


def weil_truncate(N: int, w: int, p: int, total: int) -> np.ndarray:
    """BeiDou form (b1cd.py:40-43): c[n] = W[(n+p-1) mod N], length `total`
    (truncation when total < N, wraparound covered by the mod)."""
    W = weil(N, w)
    idx = (np.arange(total, dtype=np.int64) + p - 1) % N
    return W[idx]
