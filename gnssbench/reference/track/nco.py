# Frozen copy of gnss_dsp_tpu_torch/ops/nco.py at commit 196026d.
# Changed: nothing.
"""Numerically-controlled oscillator (NCO) and carrier mixers.

Counterpart: gnss_dsp_tpu/ops/nco.py:42-93.  A 1024-entry complex
exponential table drives every oscillator; phases live in 32-bit fixed
point "turns" (1 cycle = 2^32) and the top 10 bits index the table.

PyTorch has no full uint32 arithmetic, so phases are int64 tensors kept
in [0, 2^32) with `& 0xFFFFFFFF`; increments are int64 tensors holding
int32 values.  The CUDA kernels use uint32_t for the same numbers.

The table itself is one float32 array of (cos, sin) pairs computed in
float64 and rounded once (`lut_cos_sin`); the plain versions and the
tracking kernel read the same table, so they agree exactly on the
oscillator.  (The JAX package evaluates cos/sin of the quantized angle
in float32 instead, which can differ from the table by one ulp.)
"""

from __future__ import annotations

import numpy as np
import torch

NT = 1024                 # table size (gnsstools nco.py:3)
LUT_SHIFT = 22            # 32-bit phase -> top 10 bits
MASK32 = 0xFFFFFFFF

# float64 angles rounded once to float32 (cos, sin)
_LUT_NP = np.stack([np.cos(2.0 * np.pi * np.arange(NT) / NT),
                    np.sin(2.0 * np.pi * np.arange(NT) / NT)],
                   axis=1).astype(np.float32)                    # [NT, 2]
_LUT_CACHE: dict = {}


def lut_cos_sin(device) -> torch.Tensor:
    """The shared oscillator table, float32 [NT, 2] = (cos, sin)."""
    dev = torch.device(device)
    t = _LUT_CACHE.get(dev)
    if t is None:
        t = _LUT_CACHE[dev] = torch.from_numpy(_LUT_NP).to(dev)
    return t


# ---------------------------------------------------------------- host side

def freq_to_fixed(f) -> int:
    """Cycles/sample (host float) -> int32 fixed-point increment (python
    int with int32 wraparound semantics)."""
    v = int(np.floor(np.float64(f) % 1.0 * 2.0**32)) & MASK32
    return v - (1 << 32) if v >= (1 << 31) else v


def inv_fs(fs: float) -> float:
    """float32 reciprocal of the float32 sample rate (python float).
    Division by fs is a multiply by this number, as XLA rewrites division
    by a constant."""
    return float(np.float32(1.0) / np.float32(fs))


def boc11_host(chips: float, frac: float, incr: float, n: int) -> np.ndarray:
    """BOC(1,1) square-wave subcarrier sampler (gnsstools nco.py:12-19)."""
    c = np.array([-1.0, 1.0])
    idx = ((chips % 2) + frac + incr * np.arange(n)) * 2
    idx = np.floor(idx).astype(np.int64) % 2
    return c[idx]


# -------------------------------------------------------------- device side

def fixed_u32(frac: torch.Tensor) -> torch.Tensor:
    """float32 frac in [0, 1] -> floor(frac * 2^32) as an int64 in
    [0, 2^32).  frac * 2^32 is exact in float32; the conversion
    saturates at 2^32 - 1, as the reference's float32 -> uint32 convert
    does when a tiny negative input rounds `mod 1` up to exactly 1.0."""
    u = (frac * 4294967296.0).to(torch.int64)
    return torch.clamp(u, max=MASK32)


def freq_to_fixed_t(f: torch.Tensor) -> torch.Tensor:
    """Device-side cycles/sample -> int32 increment, as an int64 tensor
    (counterpart of freq_to_fixed_jnp: float32 floor-mod, then the
    saturating uint32 convert, then the int32 reinterpretation)."""
    u = fixed_u32(torch.remainder(f.to(torch.float32), 1.0))
    return torch.where(u >= 2**31, u - 2**32, u)


def phase_indices(df_fixed, p0_fixed, n: int) -> torch.Tensor:
    """Table indices (int64 in [0, NT)) for phase p0 + i*df, i < n.
    df_fixed/p0_fixed: int64 tensors of shape [...]; result [..., n]."""
    df = torch.as_tensor(df_fixed, dtype=torch.int64)
    p0 = torch.as_tensor(p0_fixed, dtype=torch.int64, device=df.device)
    i = torch.arange(n, dtype=torch.int64, device=df.device)
    ph = (p0[..., None] + i * df[..., None]) & MASK32
    return ph >> LUT_SHIFT


def cos_sin_of_idx(idx: torch.Tensor):
    """(cos, sin) float32 table entries at integer indices."""
    lut = lut_cos_sin(idx.device)
    return lut[idx, 0], lut[idx, 1]


def nco_wave(df_fixed, p0_fixed, n: int) -> torch.Tensor:
    """complex64 e^{2 pi i (p0 + k df)} on the quantized grid, [..., n]
    (counterpart of nco_split)."""
    c, s = cos_sin_of_idx(phase_indices(df_fixed, p0_fixed, n))
    return torch.complex(c, s)


def mix(x: torch.Tensor, df_fixed, p0_fixed) -> torch.Tensor:
    """Carrier wipeoff of complex64 x [..., n] (counterpart of mix_split).
    The complex product is written out as float32 real arithmetic, the
    same four products and two sums as cplx.cmul."""
    c, s = cos_sin_of_idx(phase_indices(df_fixed, p0_fixed, x.shape[-1]))
    xr, xi = x.real, x.imag
    return torch.complex(xr * c - xi * s, xr * s + xi * c)


# ---------------------------------------------------- code-phase binning

def accum_rows(acc: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """acc [C, bins, K] float32 with val[c, i] (K values) added at
    acc[c, idx[c, i]] for every kept (c, i), one float32 addition at a
    time in the order of i: what the reference's `.at[idx].add` does on
    its CPU backend, for each of the K values (re and im together: one
    sort for both).  The order is made, not left to atomics: the kept
    entries are sorted stably by (channel, bin), each takes its rank
    among its bin's entries, and round r adds every bin's r-th entry at
    once (a bin has one entry a round, so no two additions meet).  The
    same bits on every device and every run."""
    C, bins, K = acc.shape
    flat = acc.reshape(C * bins, K).clone()
    rows = torch.arange(C, device=acc.device)[:, None].expand_as(idx)
    key = (rows * bins + idx)[keep]
    v = val[keep].to(torch.float32)
    if key.numel() == 0:
        return acc.clone()
    key, perm = torch.sort(key, stable=True)
    v = v[perm]
    pos = torch.arange(key.numel(), device=acc.device)
    start = torch.ones_like(key, dtype=torch.bool)
    start[1:] = key[1:] != key[:-1]
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    rank = pos - first
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        k = key[sel]
        flat[k] = flat[k] + v[sel]
    return flat.reshape(C, bins, K)


def accum_code_bins(x: torch.Tensor, cp0, incr, code_length: int):
    """Code-phase-binned accumulation (counterpart of nco.accum_code_bins,
    the reference's nco.accum, nco.py:58-64): a[floor(cp_i)] += x[i] with
    cp_i = (cp0 + i*incr) mod code_length, the product-sum rounded once
    to float32 (XLA contracts it), x complex64 [n].  Returns (re, im)
    float32 [code_length], added in sample order (accum_rows)."""
    n = x.shape[-1]
    dev = x.device
    i = torch.arange(n, dtype=torch.float64, device=dev)
    cp = (i * float(np.float32(incr)) + float(np.float32(cp0))
          ).to(torch.float32)
    cp = torch.remainder(cp, float(code_length))
    idx = torch.floor(cp).to(torch.int64)[None, :]
    keep = torch.ones_like(idx, dtype=torch.bool)
    z = torch.zeros((1, int(code_length), 2), dtype=torch.float32,
                    device=dev)
    acc = accum_rows(z, idx, torch.view_as_real(x)[None], keep)[0]
    return acc[:, 0], acc[:, 1]
