"""Front-end conditioning: carrier-offset wipeoff, anti-alias lowpass,
zero-phase filtering, fractional resampling to the signal's internal rate.

Counterpart: gnss_dsp_tpu/ops/frontend.py:28-158 (behavioral contract
acquire-gps-l1.py:85-96: mix(-coffset/fs) -> firwin(161, hann) ->
filtfilt -> linear-interp resample).

The JAX package ran the FIR as banded 128x128 matmuls, a TPU compile-time
workaround; here it is torch.nn.functional.conv1d (outside any kernel of
the port, so a library call).  On the card that conv must not run in
TF32 (device.resolve_device turns it off).
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_dsp_tpu_torch.ops import nco
from gnss_dsp_tpu_torch.utils import profiling


def design_lowpass(fs: float, cutoff_hz: float, ntaps: int = 161) -> np.ndarray:
    """Hann-windowed-sinc lowpass, DC gain 1 — equivalent to
    scipy.signal.firwin(ntaps, cutoff/(fs/2), window='hann')."""
    m = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    fc = cutoff_hz / (fs / 2.0)
    h = fc * np.sinc(fc * m)
    h *= np.hanning(ntaps)
    return h / np.sum(h)


def _fir_causal(x2: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """lfilter(h, [1], x) along the last axis of float32 [2, n] planes."""
    ntaps = len(h)
    # conv1d is a cross-correlation: flip h, left-pad ntaps - 1 zeros
    w = torch.from_numpy(np.ascontiguousarray(h[::-1]).astype(np.float32))
    w = w.to(x2.device).view(1, 1, ntaps)
    xp = torch.nn.functional.pad(x2[:, None, :], (ntaps - 1, 0))
    return torch.nn.functional.conv1d(xp, w)[:, 0, :]


def filtfilt_fir(h: np.ndarray, x: torch.Tensor, padlen: int | None = None):
    """Zero-phase FIR filtering of complex64 x with odd-extension edge
    padding (scipy.signal.filtfilt(h, [1], x) semantics)."""
    ntaps = len(h)
    if padlen is None:
        padlen = 3 * ntaps
    n = x.shape[0]
    v = torch.stack([x.real, x.imag])                       # [2, n] f32
    left = 2 * v[:, :1] - torch.flip(v[:, 1:padlen + 1], dims=[1])
    right = 2 * v[:, -1:] - torch.flip(v[:, -padlen - 1:-1], dims=[1])
    xe = torch.cat([left, v, right], dim=1)
    y = _fir_causal(xe, h)
    y = torch.flip(_fir_causal(torch.flip(y, dims=[1]), h), dims=[1])
    y = y[:, padlen:padlen + n]
    return torch.complex(y[0].contiguous(), y[1].contiguous())


def resample_linear(x: torch.Tensor, fs: float, fs_out: float, n_out: int):
    """Linear-interpolation resampler (np.interp on the uniform grid
    t_k = k*fs/fs_out) with host-float64 index and weight tables."""
    ratio = np.float64(fs) / np.float64(fs_out)
    t = np.arange(n_out, dtype=np.float64) * ratio
    n_in = int(x.shape[0])
    i0h = np.minimum(np.floor(t).astype(np.int64), n_in - 1)
    w = torch.from_numpy((t - i0h).astype(np.float32)).to(x.device)
    i0 = torch.from_numpy(i0h).to(x.device)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    x0 = x[i0]
    x1 = x[i1]
    one_w = 1.0 - w
    return torch.complex(x0.real * one_w + x1.real * w,
                         x0.imag * one_w + x1.imag * w)


def mix_long(x: torch.Tensor, f: float, p: float = 0.0, seg_bits: int = 20):
    """Carrier wipeoff for multi-million-sample blocks with no phase drift:
    segment-start phases are exact host integer arithmetic, so the 32-bit
    DDS truncation never accumulates past one segment."""
    n = int(x.shape[0])
    seg = 1 << seg_bits
    nseg = -(-n // seg)
    f_fix = int(np.floor(np.float64(f) % 1.0 * 2.0**32))
    p_fix = int(np.floor(np.float64(p) % 1.0 * 2.0**32))
    starts = torch.tensor([(p_fix + f_fix * seg * k) % (1 << 32)
                           for k in range(nseg)], dtype=torch.int64,
                          device=x.device)
    df = f_fix - (1 << 32) if f_fix >= (1 << 31) else f_fix
    pad = nseg * seg - n
    xp = torch.nn.functional.pad(torch.view_as_real(x), (0, 0, 0, pad))
    xp = torch.view_as_complex(xp.contiguous()).view(nseg, seg)
    dfs = torch.full((nseg,), df, dtype=torch.int64, device=x.device)
    y = nco.mix(xp, dfs, starts)
    return y.reshape(nseg * seg)[:n]


def prepare_baseband(x: torch.Tensor, fs: float, coffset: float,
                     acq_fs: float, cutoff_hz: float, ms_total: int,
                     ntaps: int = 161) -> torch.Tensor:
    """Full acquisition front end: wipeoff + zero-phase lowpass + resample.

    x: complex64 samples at fs (>= ms_total ms worth), on the device the
    work should run on.  Returns complex64 [ms_total * acq_fs / 1000].
    The span `frontend` (utils/profiling)."""
    with profiling.span("frontend", device=x.device):
        x = mix_long(x, -coffset / fs)
        h = design_lowpass(fs, cutoff_hz, ntaps)
        x = filtfilt_fir(h, x)
        n_out = int(round(ms_total * acq_fs / 1000.0))
        return resample_linear(x, fs, acq_fs, n_out)
