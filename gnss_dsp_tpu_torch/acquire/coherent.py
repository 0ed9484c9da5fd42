"""Extended-coherent acquisition with secondary-code wipeoff.

Counterpart: gnss_dsp_tpu/acquire/coherent.py (`grid_search_coherent_fast`
:67-248, `grid_search_coherent` :251-343, `acquire_signal_coherent`
:388-512, `CoherentAcqResult` :515-544; the route is acquire/plan.py).

M consecutive code periods are integrated coherently with the overlay
wiped off, trying every cyclic alignment a of the N-chip secondary:

    q[p, d, j] = max_a  sum_g | sum_m  s[(a + m) mod N] rot(d, m) R[g*M + m] |

R are the per-block complex circular correlations and rot(d, m) undoes
the residual carrier rotation of n*d/fs cycles per block (the per-block
doppler wipe restarts its phase at every block start).  The caller passes
a doppler grid fine enough for the coherent span (~1/(M*T_code)).

Two engines, picked by plan.coh_plan exactly where the JAX package picks
them:

  fused  the signal's own search geometry (circular n windows, or 2n
         LINEAR windows for pad2 and sliding signals, padded to an
         aligned length where 2n has none), the surface and its maximum
         in kernel K5 ("spec": the overlay and rotation are combined in
         spectral space first, by the linearity of the IDFT) or K6
         ("blk": per-block spectra in, combined in the kernel);
  xla    circular n windows, every surface built in plain torch (the JAX
         package's XLA einsum engine; no kernel).

On CUDA, K5 takes every window the route sends to spec (the register
core up to 81920, the run-time core at 163840: ops/acquire_coh.
spec_core_plan), K6 power-of-two windows up to 16384; a fused route at a
window its kernel does not take raises NotImplementedError naming the
signal and W.  FDMA channels (GLONASS L1/L2, no overlay: N = 1) search
one channel a call, its band offset folded into the oscillators
(acquire_signal_coherent's chan, engine.doppler_grid); on the card the
spec route at 16384 (K5 with one code row and one alignment).  The
assisted serial searches have no coherent form (serial.py).

Spans and counters (utils/profiling), on this path only: each search
counts its route (acq.route.coh_spec, .coh_blk, .coh_xla); on the spec
route the span acq.coh.combine (with its stream seconds) holds each
doppler chunk's combine, the fft_combine precompute included, and the
counter acq.coh.rows the combined rows (dc x G x A) handed to K5.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from gnss_dsp_tpu_torch.acquire import engine as eng
from gnss_dsp_tpu_torch.acquire.plan import coh_plan
from gnss_dsp_tpu_torch.device import refuse_no_pallas
from gnss_dsp_tpu_torch.ops import acquire_coh
from gnss_dsp_tpu_torch.ops.acquire2 import check_w
from gnss_dsp_tpu_torch.ops.acquire_coh import spec_core_plan
from gnss_dsp_tpu_torch.ops.nco import MASK32
from gnss_dsp_tpu_torch.utils import profiling


def _rotation(df: torch.Tensor, n: int, blocks: int):
    """(cos, sin) f32 [dc, blocks] of -2 pi * blk_cyc * m, where blk_cyc
    = (df * n mod 2^32) / 2^32 cycles per block (uint32 wraparound, as
    the reference's uint32 product)."""
    u = ((df & MASK32) * n) & MASK32
    blk_cyc = u.to(torch.float32) * (1.0 / 2**32)
    m_f = torch.arange(blocks, dtype=torch.float32, device=df.device)
    ang = (-2.0 * math.pi) * blk_cyc[:, None] * m_f[None, :]
    return torch.cos(ang), torch.sin(ang)


def _keep_best(best, metric, code_idx, al, d0):
    """Fold one doppler chunk into the running best: argmax takes the
    first maximum inside the chunk, a strict > keeps the earliest chunk."""
    b_metric, b_code, b_dop, b_al = best
    ch = torch.argmax(metric, dim=-1)
    ch_metric = torch.gather(metric, 1, ch[:, None])[:, 0]
    upd = ch_metric > b_metric
    return (torch.where(upd, ch_metric, b_metric),
            torch.where(upd, torch.gather(code_idx, 1, ch[:, None])[:, 0],
                        b_code),
            torch.where(upd, ch + d0, b_dop),
            torch.where(upd, torch.gather(al, 1, ch[:, None])[:, 0], b_al))


def _init_best(P: int, dev):
    return (torch.full((P,), -float("inf"), dtype=torch.float32, device=dev),
            torch.zeros((P,), dtype=torch.int32, device=dev),
            torch.zeros((P,), dtype=torch.int64, device=dev),
            torch.zeros((P,), dtype=torch.int32, device=dev))


def grid_search_coherent_fast(x, code_f, dopp_fixed, sec_mat, n: int,
                              window: int, blocks: int, m_coh: int,
                              dop_chunk: int, n_valid: int = 0,
                              data_window: int = 0, mode: str = "spec"):
    """Coherent search on the surface kernels K5 ("spec") or K6 ("blk").

    x          : complex64 internal-rate samples
    code_f     : complex64 [P, window] natural-order code spectra
    dopp_fixed : int [D] per-sample NCO increments
    sec_mat    : f32 [NS, A, B] = sec[(a + m) mod N] at GLOBAL block m;
                 NS == 1 shares one overlay, NS == P gives each PRN its
                 own (spec mode only)
    data_window: samples of data per window (default window); the rest
                 is zero padding
    Returns (metric f32 [P], code_idx i32 [P], dop_idx i64 [P],
    align i32 [P])."""
    P = code_f.shape[0]
    D = int(dopp_fixed.shape[0])
    G = blocks // m_coh
    NS, A = sec_mat.shape[:2]
    dev = x.device
    xb = eng.block_windows(x, n, data_window or window, blocks, pad_to=window)
    # CS100-class combine (A == m_coh == N): the overlay sum is a circular
    # correlation over the block index, IFFT(N * IFFT(rot*F) * FFT(s)); the
    # heavy transform is shared across PRNs, cheaper than the einsum for
    # large N (the JAX package's threshold)
    fft_combine = mode == "spec" and A == m_coh and A >= 25
    best = _init_best(P, dev)
    for d0 in range(0, D, dop_chunk):
        df = dopp_fixed[d0:d0 + dop_chunk].to(dev, torch.int64)
        dc = int(df.shape[0])
        F = eng.mix_fft(xb, df)                               # [dc, B, W]
        cosang, sinang = _rotation(df, n, blocks)              # [dc, B]
        if mode == "spec":
            Fg = F.reshape(dc, G, m_coh, window)
            if fft_combine:
                with profiling.span("acq.coh.combine", device=dev):
                    rot = torch.complex(cosang, -sinang).reshape(dc, G, m_coh)
                    Yc = torch.fft.ifft(Fg * rot[..., None], dim=2) * A

            def combine(k):
                """F2 [dc, G*A, W]: row g*A + a = sum_m conj(w[a, m])
                F[d, g*M + m], w = overlay sign x residual rotation."""
                profiling.count("acq.coh.rows", dc * G * A)
                with profiling.span("acq.coh.combine", device=dev):
                    if fft_combine:
                        S = torch.fft.fft(
                            sec_mat[k, :, 0].to(torch.complex64))
                        Fa = torch.fft.ifft(Yc * S[None, None, :, None],
                                            dim=2)
                    else:
                        sm = sec_mat[k][None]                  # [1, A, B]
                        wc = torch.complex(sm * cosang[:, None, :],
                                           -sm * sinang[:, None, :])
                        Fa = torch.einsum("dagm,dgmw->dgaw",
                                          wc.reshape(dc, A, G, m_coh), Fg)
                    return Fa.reshape(dc, G * A, window)

            if NS == 1:
                peak, code_idx, al = acquire_coh.corr_surface_coh_spec(
                    combine(0), code_f, A, n_valid)
            else:
                parts = [acquire_coh.corr_surface_coh_spec(
                    combine(k), code_f[k:k + 1], A, n_valid)
                    for k in range(P)]
                peak, code_idx, al = (torch.cat([p[j] for p in parts])
                                      for j in range(3))
        else:
            peak, code_idx, al = acquire_coh.corr_surface_coh(
                F, code_f, cosang, sinang, sec_mat[0], m_coh, n_valid)
        best = _keep_best(best, peak, code_idx, al, d0)
    return best


def grid_search_coherent(x, code_ffts, dopp_fixed, sec, n: int,
                         window: int, blocks: int, m_coh: int,
                         dop_chunk: int):
    """The XLA engine in plain torch (no kernel): circular windows,
    per-block complex surfaces, the overlay of each group applied at the
    block index LOCAL to the group.

    code_ffts : complex64 [P, window]; sec : f32 [N] +-1 chips (N
    alignments); blocks % m_coh == 0.  Returns as
    grid_search_coherent_fast; metric is the raw coherent peak."""
    P = code_ffts.shape[0]
    D = int(dopp_fixed.shape[0])
    G = blocks // m_coh
    N = int(sec.shape[0])
    dev = x.device
    xb = eng.block_windows(x, n, window, blocks)
    pat = ((torch.arange(N, device=dev)[:, None]
            + torch.arange(m_coh, device=dev)[None, :]) % N)
    s_mat = sec.to(dev)[pat]                                   # [N, M]
    best = _init_best(P, dev)
    for d0 in range(0, D, dop_chunk):
        df = dopp_fixed[d0:d0 + dop_chunk].to(dev, torch.int64)
        dc = int(df.shape[0])
        F = eng.mix_fft(xb, df)                               # [dc, B, W]
        R = torch.fft.ifft(code_ffts[:, None, None, :]
                           * torch.conj(F)[None], dim=-1)      # [P,dc,B,W]
        Rg = R.reshape(P, dc, G, m_coh, window)
        c, s = _rotation(df, n, m_coh)                         # [dc, M]
        w = torch.complex(s_mat[:, None, :] * c[None],
                          s_mat[:, None, :] * s[None])         # [A, dc, M]
        qa = torch.einsum("adm,pdgmw->apdgw", w, Rg).abs().sum(dim=3)
        q, a_idx = torch.max(qa, dim=0)                        # [P, dc, W]
        code_idx = torch.argmax(q, dim=-1)
        peak = torch.gather(q, -1, code_idx[..., None])[..., 0]
        al = torch.gather(a_idx, -1, code_idx[..., None])[..., 0]
        best = _keep_best(best, peak, code_idx.to(torch.int32),
                          al.to(torch.int32), d0)
    return best


@dataclass
class CoherentAcqResult(eng.AcqResult):
    """AcqResult + the winning overlay alignment: acquisition block m
    correlated best with overlay chip (align + m) mod n_overlay.
    linear=True marks the fused engine's 2n-window route, where align
    names the first full code period, the one the track driver starts
    on."""
    align: int = 0
    n_overlay: int = 1
    linear: bool = False

    def track_overlay_phase(self, code_length: int) -> int:
        """Overlay chip index of the first code period the track driver
        processes (it discards samples up to the first code boundary, so
        it starts at capture period 1).  Linear windows: align names that
        period.  Circular windows: block 0 is mostly period 0 when the
        boundary falls in its second half (code_offset <= L/2), and then
        period 1 carries align + 1."""
        if self.linear:
            a = self.align
        else:
            a = self.align + (1 if self.code_offset <= code_length / 2
                              else 0)
        return a % self.n_overlay


def coh_dop_chunk(fast, P: int, blocks: int, m_coh: int, N: int,
                  window: int, D: int) -> int:
    """Dopplers per chunk of the coherent search on route `fast`
    (plan.coh_plan's, None for the XLA engine): the fused route budgets
    256 MiB of [dc, B, W] spectra, and in spec mode of [dc, G*A, W]
    combined rows, whichever is larger (the combine's temporaries are a
    few such arrays); the XLA engine 64 MiB of [P, dc, B, W] surfaces."""
    if fast:
        cells = blocks
        if fast[0] == "spec":
            cells = max(blocks, (blocks // m_coh) * N)
        dc = 256 * 2**20 // (cells * window * 8)
    else:
        dc = 64 * 2**20 // (P * blocks * window * 8)
    return min(D, max(1, dc))


def acquire_signal_coherent(sig, x_int: torch.Tensor, prns, doppler_search,
                            m_coh: int | None = None, ms: int | None = None,
                            dop_chunk: int | None = None,
                            engine: str = "auto", chan: int = 0) -> list:
    """Secondary-wiped extended-coherent acquisition of `sig`.

    x_int: complex64 internal-rate samples on the device the search runs
    on.  m_coh defaults to the full secondary length (NH10 -> 10 ms, NH20
    -> 20 ms ...); ms to one coherent group.  Signals without a secondary
    get an all-ones overlay.  engine: "auto" takes the fused route where
    plan.coh_plan gives one, "fused" requires it, "xla" forces the
    circular plain-torch engine.  chan: the FDMA channel whose band
    offset the oscillators carry (0 for CDMA signals).  Returns
    list[CoherentAcqResult] in PRN order.  Under GNSS_DSP_NO_PALLAS
    plan.coh_plan gives no fused route, so "auto" takes the XLA engine
    (the reference's coherent.py:356) on the CPU, and a card refuses the
    switch (device.refuse_no_pallas); GNSS_DSP_NO_V2P moves nothing
    here, as in the reference."""
    refuse_no_pallas("acquire_signal_coherent", x_int.device)
    if sig.acq_serial:
        raise ValueError(
            f"{sig.name} is an assisted serial search, with no coherent form "
            "(acquire/serial.serial_search)")
    if engine not in ("auto", "fused", "xla"):
        raise ValueError(f"engine {engine!r}: want auto, fused or xla")
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    secs = [np.asarray(sig.secondary(p) if sig.secondary is not None
                       else np.ones(1, np.int8), np.float32)
            for p in prns]
    sec = secs[0]
    # CS100-class signals carry a different secondary per PRN: each PRN
    # then gets its own overlay in the combine
    per_prn = any(s.shape != sec.shape or not np.array_equal(s, sec)
                  for s in secs[1:])
    if m_coh is None:
        m_coh = len(sec)
    m_coh = int(m_coh)
    if ms is None:
        ms = int(m_coh * sig.acq_coherent_ms)
    blocks = int(ms / sig.acq_coherent_ms)
    blocks = max(blocks // m_coh, 1) * m_coh
    N = len(sec)

    # the fused engine applies the overlay at the GLOBAL block index, the
    # XLA engine per group at the LOCAL one: they agree iff m_coh % N == 0
    fast = (coh_plan(sig, n, m_coh, N)
            if engine in ("auto", "fused") and m_coh % N == 0 else None)
    if fast and per_prn and fast[0] != "spec":
        fast = None        # per-PRN overlays need the spec combine
    if engine == "fused" and fast is None:
        # the divisibility blocker first: it gates every fused route
        raise ValueError(
            f"fused engine needs m_coh % overlay_len == 0 "
            f"(m_coh={m_coh}, overlay={N})" if m_coh % N else
            "per-PRN overlays need the spec-plan shape" if per_prn else
            "no fused coherent plan for this shape")
    window = fast[1] if fast else n     # XLA engine: circular, no pad
    dev = x_int.device
    if fast and dev.type == "cuda":
        try:
            if fast[0] == "spec":
                spec_core_plan(window)
            else:
                check_w(window, "K6")
        except NotImplementedError as e:
            raise NotImplementedError(
                f"{sig.name}: the coherent {fast[0]} route at W={window}: "
                f"{e}") from None
    # the blocks' windows (2n linear ones reach one code period past the
    # last block) must lie inside the capture, as the reference's reshape
    # requires: say so before any work
    need = (blocks + (fast[2] // n if fast else 1) - 1) * n
    if x_int.shape[0] < need:
        raise ValueError(
            f"{sig.name}: {blocks} blocks of {m_coh}-period groups need "
            f"{need} samples ({need / sig.acq_fs * 1e3:g} ms), the capture "
            f"holds {x_int.shape[0]}: give ms (--time) one code period more")

    dops, fixed = eng.doppler_grid(sig, doppler_search, chan)
    if dop_chunk is None:
        dop_chunk = coh_dop_chunk(fast, len(prns), blocks, m_coh, N, window,
                                  len(dops))
    fixed_t = torch.from_numpy(fixed.astype(np.int64))
    profiling.count(f"acq.route.coh_{fast[0] if fast else 'xla'}")

    if fast:
        mode, window_t, dw, n_valid = fast
        code_f = eng.device_code_ffts(sig, prns, n, window_t, dev)
        pat = (np.arange(N)[:, None] + np.arange(blocks)[None, :]) % N
        sm = np.stack([s[pat] for s in (secs if per_prn else [sec])]
                      ).astype(np.float32)                    # [NS, A, B]
        metric, code_idx, dop_idx, align = grid_search_coherent_fast(
            x_int, code_f, fixed_t, torch.from_numpy(sm).to(dev), n=n,
            window=window_t, blocks=blocks, m_coh=m_coh,
            dop_chunk=dop_chunk, n_valid=n_valid, data_window=dw, mode=mode)
        linear = dw == 2 * n
    else:
        cf = eng.device_code_ffts(sig, prns, n, window, dev)
        if per_prn:
            # one search per PRN, each with its own overlay (the data FFT
            # is redone per PRN)
            parts = [grid_search_coherent(
                x_int, cf[k:k + 1], fixed_t, torch.from_numpy(secs[k]),
                n=n, window=window, blocks=blocks, m_coh=m_coh,
                dop_chunk=dop_chunk) for k in range(len(prns))]
            metric, code_idx, dop_idx, align = (
                torch.cat([p[j] for p in parts]) for j in range(4))
        else:
            metric, code_idx, dop_idx, align = grid_search_coherent(
                x_int, cf, fixed_t, torch.from_numpy(sec), n=n,
                window=window, blocks=blocks, m_coh=m_coh,
                dop_chunk=dop_chunk)
        linear = False
    metric = metric.cpu().numpy()
    code_idx = code_idx.cpu().numpy()
    dop_idx = dop_idx.cpu().numpy()
    align = align.cpu().numpy()
    out = []
    for i, prn in enumerate(prns):
        code = (sig.code_length * float(code_idx[i]) / n) % sig.code_length
        out.append(CoherentAcqResult(
            prn=prn, doppler=float(dops[dop_idx[i]]),
            metric=float(metric[i]), code_offset=code,
            align=int(align[i]), n_overlay=N, linear=linear))
    return out
