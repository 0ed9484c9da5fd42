"""Entry `coherent`: the high-sensitivity search, one extended-coherent
search after another through the acquire CLI (cli/acquire.main with the
configuration row's `--coherent M` argv), each on one epoch file: the
capture cut at successive epoch_ms epochs into files of file_ms (what the
CLI reads for its --time), written once in set-up and cycled, as entry
`acquire` does.

The captures carry each satellite's secondary code and data: code period
k of a satellite takes the sign nh[(k + h) mod N] * bit[(k + h) // N], h
its overlay phase at the capture's start and the bits +-1 at one a whole
overlay period (BeiDou D1: NH20 on 50 bit/s, its edges on the NH20
period's), all drawn from the seed (synth_band_bits).  The frozen
gnssbench/synth.synth_band writes +1 data only; synth_band_bits is its
copy with those signs, the same noise, scale and quantisation.

The results are taken at full precision where the CLI calls the engine
(cli/acquire.acquire_signal_coherent), each row's alignment with them.
After the window every repeat of a search on one epoch is held to its
first, and check_searches of the searches, drawn from the seed, are
judged against the float64 reference of gnssbench/reference/coherent.py:
in each every code row that holds a satellite of the sky and check_rows
more drawn from the seed, their surfaces computed one doppler at a time;
every row of the search must be reported once."""

from __future__ import annotations

import contextlib
import time

import numpy as np

from gnssbench import synth
from gnssbench.entries.acquire import Acquire
from gnssbench.reference import coherent as rcoh
from gnssbench.reference.models import get_signal as ref_signal
from gnssbench.workload import PROGRAM, draw_sky


def data_signs(sig, prn: int, seed: int, periods: int) -> np.ndarray:
    """+-1 a code period for `periods` periods: the overlay chip times
    the data bit, overlay phase and bits drawn from (seed, prn); one
    data bit a whole overlay period, its edges on the overlay's."""
    nh = rcoh.overlay(sig, prn)
    N = len(nh)
    rng = np.random.default_rng([int(seed), 5081, int(prn)])
    h = int(rng.integers(N))
    k = np.arange(periods) + h
    bits = 1.0 - 2.0 * rng.integers(0, 2, size=k[-1] // N + 1)
    return nh[k % N] * bits[k // N]


def synth_band_bits(seeds, fs: float, seconds: float, seed: int, band: int,
                    device) -> np.ndarray:
    """gnssbench/synth.synth_band with each seed's data_signs as its data
    bits: one band's interleaved int8 I/Q bytes (host int8 [2 n])."""
    import torch

    n = int(fs * seconds)
    frame = int(fs * synth.CHUNK_MS / 1000)
    sigma = float(np.sqrt(fs / (2.0 * 10 ** (synth.CN0_REF / 10.0))))
    scale = 100.0 / (4.0 * sigma)
    out = np.empty(2 * n, np.int8)
    rows = []
    for s in seeds:
        sig = ref_signal(s["signal"])
        prn = int(s["prn"])
        periods = int(seconds * 1000.0 / sig.code_period_ms) + 2
        rows.append((sig, prn, data_signs(sig, prn, seed, periods)))
    for k, t0 in enumerate(range(0, n, frame)):
        m = min(frame, n - t0)
        x = torch.zeros(m, dtype=torch.complex64, device=device)
        for s, (sig, prn, bits) in zip(seeds, rows):
            chan = prn if sig.fdma_hz else 0
            amp = float(10.0 ** ((float(s["cn0"]) - synth.CN0_REF) / 20.0))
            x += amp * synth.synth_iq_t(
                sig.code_table((prn,))[0], sig.chip_rate, fs, m,
                float(s["doppler"]) + sig.fdma_hz * chan + float(s["coffset"]),
                float(s["code_phase"]), sig.subcarrier,
                sig.track_carrier_ratio(chan),
                code_doppler_hz=float(s["doppler"]), device=device, t0=t0,
                data_bits=bits)
        g = torch.Generator(device=device).manual_seed(
            synth.noise_seed(seed, band, k))
        x += sigma * torch.complex(
            torch.randn(m, generator=g, device=device),
            torch.randn(m, generator=g, device=device))
        iq = torch.view_as_real(x * scale).round().clamp(-127, 127)
        out[2 * t0:2 * (t0 + m)] = iq.to(torch.int8).reshape(-1).cpu().numpy()
    return out


class Coherent(Acquire):

    def setup(self):
        cfg, tr = self.config, self.traffic
        self.rows = cfg["acquire"]
        sky = draw_sky(cfg, self.seed)
        seconds = float(cfg["acquire_capture_s"])
        self.raw = {b: synth_band_bits(sky.get(b, []), self.fs, seconds,
                                       self.seed, b, self.device)
                    for b in sorted({int(r["band"]) for r in self.rows})}
        self.plan = []                # (row, epoch file, its byte offset)
        step = int(self.fs * tr["epoch_ms"] / 1000)
        nfile = int(self.fs * tr["file_ms"] / 1000)
        for b, raw in self.raw.items():
            for e, s0 in enumerate(range(0, len(raw) // 2 - nfile + 1,
                                         step)):
                path = self.write(f"band{b}_epoch{e}.iq",
                                  raw[2 * s0:2 * (s0 + nfile)])
                self.plan += [(i, path, 2 * s0)
                              for i, r in enumerate(self.rows)
                              if int(r["band"]) == b]
        self.sky = [dict(s, band=b) for b, ss in sky.items() for s in ss]
        self.cells = [self.search_cells(r) for r in self.rows]
        self.done = []                # (row, path, offset, results)
        self._got = None
        self._install()

    def _install(self):
        def capture(fn):
            def run(*a, **k):
                out = fn(*a, **k)
                if self.fault == "half":
                    out = out[:len(out) // 2]
                elif self.fault == "alter" and out:
                    # the search's best row: the one a user acts on
                    max(out, key=lambda r: r.metric).code_offset += 1.0
                elif self.fault == "stale":
                    prev = getattr(self, "_prev", None)
                    self._prev = out
                    out = prev if prev is not None else out
                self._got.extend((r.prn, r.doppler, r.metric, r.code_offset,
                                  r.align) for r in out)
                return out
            return run
        self.patches.wrap(f"{PROGRAM}.cli.acquire", "acquire_signal_coherent",
                          capture)

    def _m_coh(self, row):
        opts = dict(zip(row["argv"][::2], row["argv"][1::2]))
        m = int(opts["--coherent"])
        return None if m < 0 else m

    def _one(self, i, path, offset):
        if self.control != "tf32-reference":
            return super()._one(i, path, offset)
        row = self.rows[i]
        sig, prns, dops, ms, n = self._search_args(row)
        raw = self.raw[int(row["band"])][offset:offset + 2 * n]
        t0 = time.perf_counter()
        self._got = rcoh.results(sig, raw, self.fs, float(row["coffset"]),
                                 prns, dops, ms, self.device, "tf32",
                                 self._m_coh(row))
        self.searches.append(time.perf_counter() - t0)
        self.done.append((i, path, offset, list(self._got)))

    def judged_rows(self, row, ids, rng):
        """The rows of a search that the check judges: every one holding a
        satellite of the sky, and check_rows more drawn with rng."""
        held = {int(s["prn"]) for s in self.sky
                if s["signal"] == row["signal"]
                and int(s["band"]) == int(row["band"])}
        rest = [i for i in ids if i not in held]
        more = rng.permutation(len(rest))[:int(self.traffic["check_rows"])]
        return [i for i in ids if i in held] + [rest[j] for j in sorted(more)]

    def check(self, limits):
        """({number compared: value}, {what was checked: count}) of the
        window's searches: every repeat of a search on one epoch against
        its first, and check_searches of the searches, drawn from the
        seed, against the float64 reference (their rows as judged_rows
        picks them).  A reported cell ties with its row's best within
        metric_err's limit."""
        tie = float(limits["metric_err"])
        groups = {}
        for i, path, off, res in self.done:
            groups.setdefault((i, path, off), []).append(res)
        repeat = sum(sum(r != rs[0] for r in rs[1:])
                     for rs in groups.values())
        keys = sorted(groups)
        rng = self.rng()
        pick = sorted(rng.permutation(len(keys))[:int(
            self.traffic["check_searches"])])
        err = 0.0
        wrong = missing = judged = 0
        for j in pick:
            i, _path, off = keys[j]
            row = self.rows[i]
            sig, prns, dops, ms, n = self._search_args(row)
            raw = self.raw[int(row["band"])][off:off + 2 * n]
            rows = self.judged_rows(row, prns, rng)
            surf = rcoh.surface(sig, raw, self.fs, float(row["coffset"]),
                                rows, dops, ms, self.device,
                                m_coh=self._m_coh(row))
            e, w, m = rcoh.judge(sig, surf, rows, dops, tie, prns,
                                 groups[keys[j]][0])
            err, wrong, missing = max(err, e), wrong + w, missing + m
            judged += len(rows)
        return ({"metric_err": err, "cells_wrong": wrong,
                 "rows_missing": missing, "repeats_differ": repeat},
                {"searches_checked": len(pick), "rows_judged": judged,
                 "searches_done": len(self.done)})


ENTRY = Coherent
