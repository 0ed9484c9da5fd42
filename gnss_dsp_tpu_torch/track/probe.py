"""Correlation-shape probe: the multi-lag correlation function around the
prompt, accumulated sign-coherently over blocks.

Counterpart: gnss_dsp_tpu/track/probe.py:19-85.  The reference carries
this as commented-out debug scaffolding (track-gps-l1cp.py:47-55: 320
lags at 0.0125-chip spacing, sign-corrected by the prompt's I arm); here,
as in the JAX package, it is a diagnostic.  The lag sweep is one batched
gather-and-sum over [n_lags, n] on the block's device, with the
reference's float32 chip arithmetic (fr + i * cf, floor, mod) and its
four subcarrier kinds.  No kernel: the reference's is an XLA vmap, not a
Pallas call.
"""

from __future__ import annotations

import numpy as np
import torch


def _square(cp_i: torch.Tensor, k: float) -> torch.Tensor:
    """The +-1 square wave 1 - 2 * (floor(k * cp_i) mod 2), float32."""
    return (1 - 2 * torch.remainder(torch.floor(k * cp_i).to(torch.int32),
                                    2)).to(torch.float32)


def correlation_shape(x: torch.Tensor, code_tab: torch.Tensor, code_p,
                      cf, lag_spacing, n_lags: int, code_length: int,
                      subcarrier: str = "none") -> torch.Tensor:
    """Correlate one carrier-wiped block against `n_lags` code lags
    centred on code_p: lag_k = lag_spacing * (k - n_lags // 2).

    x: complex64 [n]; code_tab: int8 [L] on x's device; code_p, cf and
    lag_spacing are float32 scalars.  Returns complex64 [n_lags], the
    correlation function, on x's device."""
    dev = x.device
    f32 = torch.float32
    n = x.shape[0]
    i = torch.arange(n, dtype=torch.int32, device=dev).to(f32)
    k = torch.arange(n_lags, dtype=torch.int32, device=dev) - n_lags // 2
    lag = torch.tensor(lag_spacing, dtype=f32).to(dev) * k.to(f32)
    v = torch.tensor(code_p, dtype=f32).to(dev) + lag                # [K]
    vint = torch.floor(v)
    fr = v - vint
    cp_i = fr[:, None] + i[None, :] * torch.tensor(cf, dtype=f32).to(dev)
    cidx = torch.remainder(vint.to(torch.int32)[:, None]
                           + torch.floor(cp_i).to(torch.int32), code_length)
    chips = code_tab.to(dev)[cidx.long()].to(f32)                    # [K, n]
    # boc11, cboc and tmboc shape the chips; any other kind leaves them
    # as they are, as in the reference
    if subcarrier == "boc11":
        chips = chips * _square(cp_i, 2.0)
    elif subcarrier == "cboc":
        chips = chips * (0.953463 * _square(cp_i, 2.0)
                         + 0.301511 * _square(cp_i, 12.0))
    elif subcarrier == "tmboc":
        u = torch.remainder(cidx, 33)
        slot = ((u == 0) | (u == 4) | (u == 6) | (u == 29)).to(f32)
        chips = chips * (slot * _square(cp_i, 12.0)
                         + (1.0 - slot) * _square(cp_i, 2.0))
    return torch.complex((x.real[None, :] * chips).sum(dim=1),
                         (x.imag[None, :] * chips).sum(dim=1))


class ShapeAccumulator:
    """Sign-coherent multi-block accumulation (the reference's
    `s.shape[dci] +=/-= pp` with the data-bit wipe), in float64 on the
    host."""

    def __init__(self, n_lags: int = 320, lag_spacing: float = 0.0125):
        self.n_lags = int(n_lags)
        self.lag_spacing = float(lag_spacing)
        self.re = np.zeros(self.n_lags)
        self.im = np.zeros(self.n_lags)
        self.blocks = 0

    def update(self, x_wiped, code_tab, code_p: float, cf: float,
               prompt_re: float, code_length: int, subcarrier="none"):
        s = 1.0 if prompt_re > 0 else -1.0
        c = correlation_shape(x_wiped, code_tab, np.float32(code_p),
                              np.float32(cf), np.float32(self.lag_spacing),
                              self.n_lags, code_length, subcarrier).cpu()
        self.re += s * c.real.numpy()
        self.im += s * c.imag.numpy()
        self.blocks += 1

    def lags(self) -> np.ndarray:
        return self.lag_spacing * (np.arange(self.n_lags) - self.n_lags // 2)
