# Frozen copy of gnss_dsp_tpu_torch/models/codes/data.py at commit 196026d.
# Changed: imports point at gnssbench.reference.models.
"""Loader for the packed ICD constant tables (data/icd_tables.npz).

The npz holds interface-control-document constants (per-PRN LFSR initial
states, Weil-code parameter pairs, memory-code bit planes, secondary-code
chips) extracted once by tools/extract_icd_tables.py.  Everything here is
public ICD data; the generators in this package turn it into chip tables.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

_PATH = os.path.join(os.path.dirname(__file__), "data", "icd_tables.npz")


@lru_cache(maxsize=1)
def _npz():
    return np.load(_PATH, allow_pickle=False)


def table(name: str) -> np.ndarray:
    return _npz()[name]


@lru_cache(maxsize=None)
def pairs(name: str) -> dict:
    """'<name>' stored as int64 [n, 1+k] (prn, v...) -> {prn: v or tuple}."""
    arr = _npz()[name]
    out = {}
    for row in arr:
        prn, vals = int(row[0]), [int(v) for v in row[1:] if v != -1]
        out[prn] = vals[0] if len(vals) == 1 else tuple(vals)
    return out


@lru_cache(maxsize=None)
def memory_bits(family: str):
    """Packed memory-code family -> (prns list, uint8 {0,1} [n, L])."""
    z = _npz()
    prns = [int(p) for p in z[family + "_prns"]]
    shape = tuple(int(s) for s in z[family + "_shape"])
    bits = np.unpackbits(z[family + "_bits"])[: shape[0] * shape[1]]
    return prns, bits.reshape(shape)


@lru_cache(maxsize=None)
def init_bits(name: str):
    """Bit-string init family -> {prn: uint8 [nbits] (x[0] first)}."""
    z = _npz()
    prns = z[name + "_prns"]
    bits = z[name]
    return {int(p): bits[i] for i, p in enumerate(prns)}
