"""Assisted serial acquisition for the long codes: GPS L2CL given an L2CM
fix (75 hypotheses of 10230 chips, 20 ms blocks) and GLONASS P given a
C/A fix (1000 hypotheses of 5110 chips, 4 ms blocks).

Counterpart: gnss_dsp_tpu/acquire/serial.py (`SerialResult`,
`HypothesisGeometry`, `hypothesis_geometry`, `wipe_blocks`,
`hypothesis_q`, `serial_search`).

For hypothesis k and block b the code starts at chip

    start[k, b] = k * stride + b * adv + phase0

(adv = stride for L2CL, whose 20 ms block is one stride; n * incr for
GLONASS P), computed on the host in float64 and split into an int32
chip s_int = floor(start) mod L and a float32 fraction s_frac: GLONASS
P's starts reach 5.11e6 chips, past float32's exact integers.  Sample i
of block b reads chip

    idx = (s_int + floor(s_frac + i * incr)) mod L

with i * incr rounded to float32 and then the sum rounded, as the JAX
package's float32 program (n = int(fs * coh / 1000) samples a block,
truncated, not rounded).  Each block is wiped by one n-sample oscillator
at -(doppler + fdma_hz * chan) / fs from phase 0, and

    q[k] = sum_b | sum_i code[idx] * xw[b, i] |

The code table is int8 [L] on the device and the chips are gathered by
indexing.  The sums over samples are float64 (the gathered +-1 chips times
the float32 samples, one float64 matmul a chunk of hypotheses), and q is
rounded to float32 once: so q does not depend on how the hypotheses are
chunked nor on the device, and it agrees with the JAX package's float32
einsum (Precision.HIGHEST) to that einsum's rounding.  No kernel: the JAX
package computes this outside any Pallas kernel too (a gather and an
einsum).  The sharded twin is parallel/acquire.serial_search_sharded.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gnss_dsp_tpu_torch.ops import nco

# float32 bytes of one chunk of gathered chips (the JAX package's bound)
CHUNK_BYTES = 64 * 2**20


@dataclass
class SerialResult:
    prn: int
    doppler: float
    metric: float
    k: int
    code_offset: float


@dataclass
class HypothesisGeometry:
    """Host-side geometry of a serial search: blocks, sizes, and the
    int/frac-split start chips for every (hypothesis, block)."""
    blocks: int
    n: int
    incr: float
    L: int
    stride: float
    phase0: float
    s_int: np.ndarray    # int32 [K, B]
    s_frac: np.ndarray   # f32 [K, B]


def hypothesis_geometry(sig, fs: float, ms: int,
                        parent_code_phase: float) -> HypothesisGeometry:
    K = sig.acq_serial
    coh = sig.acq_serial_coh_ms
    blocks = max(int(ms // coh), 1)
    n = int(fs * coh / 1000.0)
    incr = sig.chip_rate / fs
    L = sig.code_length
    stride = sig.acq_serial_stride
    phase0 = sig.acq_serial_scale * parent_code_phase

    # L2CL advances (k + b) * stride + phase, GLONASS P k * stride +
    # b * n * incr + phase: both k * stride + b * adv
    chips_per_block = coh * sig.chip_rate / 1000.0
    block_adv = stride if abs(chips_per_block - stride) < 1e-6 else n * incr
    kk = np.arange(K, dtype=np.float64)[:, None]
    bb = np.arange(blocks, dtype=np.float64)[None, :]
    starts = kk * stride + bb * block_adv + phase0
    s_int = np.floor(starts).astype(np.int64)
    s_frac = (starts - s_int).astype(np.float32)
    s_int = (s_int % L).astype(np.int32)
    return HypothesisGeometry(blocks=blocks, n=n, incr=incr, L=L,
                              stride=stride, phase0=phase0,
                              s_int=s_int, s_frac=s_frac)


def wipe_blocks(sig, x: torch.Tensor, doppler: float, fs: float, chan: int,
                geom: HypothesisGeometry) -> torch.Tensor:
    """complex64 [B, n]: the first B blocks of x, each wiped by the same
    n-sample oscillator (phase 0 at every block start)."""
    df = torch.tensor(
        nco.freq_to_fixed(-(doppler + sig.fdma_hz * chan) / fs),
        dtype=torch.int64, device=x.device)
    nb = geom.blocks * geom.n
    if x.shape[0] < nb:
        raise ValueError(f"{sig.name}: {geom.blocks} blocks of {geom.n} "
                         f"samples need {nb}, the capture holds {x.shape[0]}")
    return nco.mix(x[:nb].reshape(geom.blocks, geom.n), df,
                   torch.zeros_like(df))


def code_indices(s_int: torch.Tensor, s_frac: torch.Tensor, incr: float,
                 n: int, L: int) -> torch.Tensor:
    """int64 [B, Kc, n] chip indices of hypotheses s_int, s_frac [Kc, B]
    (the block axis first, the matmul's batch)."""
    i = torch.arange(n, dtype=torch.float32, device=s_int.device)
    step = i * torch.tensor(np.float32(incr), device=s_int.device)
    cp = s_frac.t()[:, :, None] + step                   # float32, rounded
    return torch.remainder(s_int.t().to(torch.int64)[:, :, None]
                           + torch.floor(cp).to(torch.int64), L)


def hypothesis_q(xw: torch.Tensor, code_tab: torch.Tensor,
                 s_int: torch.Tensor, s_frac: torch.Tensor, incr: float,
                 n: int, L: int) -> torch.Tensor:
    """q float32 [Kc] of one chunk of hypotheses.

    xw      : complex64 [B, n] carrier-wiped data blocks
    code_tab: int8 [L]
    s_int   : int32 [Kc, B] integer chip starts
    s_frac  : float32 [Kc, B] fractional chip starts"""
    c = code_tab[code_indices(s_int, s_frac, incr, n, L)].to(torch.float64)
    xd = torch.stack([xw.real, xw.imag], dim=-1).to(torch.float64)  # [B,n,2]
    y = torch.matmul(c, xd)                                      # [B, Kc, 2]
    return torch.sqrt(y[..., 0] ** 2 + y[..., 1] ** 2).sum(dim=0).to(
        torch.float32)


def default_k_chunk(K: int, geom: HypothesisGeometry) -> int:
    """Hypotheses a chunk: CHUNK_BYTES of float32 [Kc, B, n] chips."""
    return max(1, min(K, CHUNK_BYTES // (geom.blocks * geom.n * 4)))


def chunked_q(xw: torch.Tensor, code_tab: torch.Tensor, s_int: np.ndarray,
              s_frac: np.ndarray, geom: HypothesisGeometry,
              k_chunk: int) -> torch.Tensor:
    """q float32 [K] of the hypotheses s_int, s_frac [K, B], k_chunk at a
    time, on xw's device."""
    dev = xw.device
    si = torch.from_numpy(s_int).to(dev)
    sf = torch.from_numpy(s_frac).to(dev)
    return torch.cat([hypothesis_q(xw, code_tab, si[k0:k0 + k_chunk],
                                   sf[k0:k0 + k_chunk], geom.incr, geom.n,
                                   geom.L)
                      for k0 in range(0, s_int.shape[0], k_chunk)])


def device_code(sig, prn: int, device) -> torch.Tensor:
    """int8 [L] code of `prn` on `device`."""
    return torch.from_numpy(sig.code_table((prn,))[0].astype(np.int8)).to(
        device)


def best_of(prn: int, doppler: float, q: np.ndarray,
            geom: HypothesisGeometry) -> SerialResult:
    """The first maximum of q as a SerialResult; code_offset in float64."""
    k_best = int(np.argmax(q))
    return SerialResult(
        prn=prn, doppler=doppler, metric=float(q[k_best]), k=k_best,
        code_offset=float((geom.stride * k_best + geom.phase0) % geom.L))


def serial_search(sig, x: torch.Tensor, prn: int, doppler: float,
                  parent_code_phase: float, fs: float, ms: int = 40,
                  chan: int = 0, k_chunk: int | None = None) -> SerialResult:
    """Search sig.acq_serial hypotheses at native rate fs.

    x: complex64 samples (>= blocks * n) on the device the search runs
    on, already wiped of the carrier offset (the CLI does that).  chan:
    the FDMA channel (GLONASS P) whose band offset the oscillator carries.
    k_chunk: hypotheses a chunk (default: CHUNK_BYTES of chips); the
    result does not depend on it."""
    if not sig.acq_serial:
        raise ValueError(f"{sig.name} has no assisted serial search")
    K = sig.acq_serial
    geom = hypothesis_geometry(sig, fs, ms, parent_code_phase)
    xw = wipe_blocks(sig, x, doppler, fs, chan, geom)
    q = chunked_q(xw, device_code(sig, prn, x.device), geom.s_int,
                  geom.s_frac, geom, k_chunk or default_k_chunk(K, geom))
    return best_of(prn, doppler, q.cpu().numpy(), geom)
