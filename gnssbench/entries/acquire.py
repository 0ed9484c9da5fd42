"""Entry `acquire`: one search after another through the acquire CLI
(cli/acquire.main), each of one configured row on one epoch file: the
capture cut at successive epoch_ms epochs into files of file_ms (what
the CLI reads for its --time), written once in set-up and cycled.  Rows
go to a sink file; the results are taken at full precision where the
CLI calls the engine (cli/acquire.acquire_signal, acquire_signal_fdma).
After the window every repeat of a search is held to its first, and a
sample of the epochs drawn from the seed to the float64 reference
(gnssbench/reference/acquire.py)."""

from __future__ import annotations

import contextlib
import time

from gnssbench import synth
from gnssbench.reference import acquire as ref_acq
from gnssbench.reference.models import get_signal as ref_signal
from gnssbench.workload import PROGRAM, Entry, draw_sky


class Acquire(Entry):
    MODULES = (f"{PROGRAM}.cli.acquire",)

    def setup(self):
        cfg, tr = self.config, self.traffic
        self.rows = cfg["acquire"]
        sky = draw_sky(cfg, self.seed)
        seconds = float(cfg["acquire_capture_s"])
        self.raw = {b: synth.synth_band(sky.get(b, []), self.fs, seconds,
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
        self.cells = [self.search_cells(r) for r in self.rows]
        self.done = []                # (row, path, offset, results)
        self._got = None
        self._install()

    def search_cells(self, row):
        sig, prns, dops, ms, _n = self._search_args(row)
        return ref_acq.search_cells(sig, len(prns), len(dops), ms)

    def _install(self):
        def capture(fn):
            def run(*a, **k):
                out = fn(*a, **k)
                if self.fault == "half":
                    out = out[:len(out) // 2]
                elif self.fault == "alter" and out:
                    out[0].code_offset += 1.0
                elif self.fault == "stale":
                    prev = getattr(self, "_prev", None)
                    self._prev = out
                    out = prev if prev is not None else out
                self._got.extend((r.prn, r.doppler, r.metric, r.code_offset)
                                 for r in out)
                return out
            return run
        where = f"{PROGRAM}.cli.acquire"
        self.patches.wrap(where, "acquire_signal", capture)
        self.patches.wrap(where, "acquire_signal_fdma", capture)

    def _one(self, i, path, offset):
        from gnss_dsp_tpu_torch.cli import acquire as acq_cli

        row = self.rows[i]
        self._got = []
        t0 = time.perf_counter()
        if self.control == "tf32-reference":
            self._got = self._reference(row, offset, "tf32")
        else:
            argv = list(row.get("argv", [])) + [
                path, str(int(self.fs)), str(row["coffset"]),
                "--device", str(self.device)]
            with contextlib.redirect_stdout(self.sink):
                rc = acq_cli.main(row["signal"], argv)
            self.sink.flush()
            if rc != 0:
                raise RuntimeError(f"acquire {row['signal']} exited {rc}")
        self.searches.append(time.perf_counter() - t0)
        self.done.append((i, path, offset, list(self._got)))

    def warm(self):
        seen = set()
        for i, path, off in self.plan:
            if i not in seen:
                seen.add(i)
                self._one(i, path, off)
        self.done.clear()
        self.searches.clear()
        self._prev = None

    def request(self, k):
        i, path, off = self.plan[k % len(self.plan)]
        self._one(i, path, off)
        return float(self.cells[i])

    def _search_args(self, row):
        """(signal, rows, dopplers, ms, samples read) of a configured
        search: the script's defaults, or its argv's --prn / --channel,
        --doppler-search and --time."""
        sig = ref_signal(row["signal"])
        opts = dict(zip(row.get("argv", [])[::2], row.get("argv", [])[1::2]))
        ms = int(opts.get("--time", sig.acq_ms_default))
        prns = sig.prns(opts.get("--prn", opts.get("--channel")))
        grid = (tuple(float(v) for v in opts["--doppler-search"].split(","))
                if "--doppler-search" in opts else sig.doppler_default)
        return (sig, prns, ref_acq.doppler_grid(grid), ms,
                int((ms + 5) * self.fs / 1000))

    def _reference(self, row, offset, precision):
        sig, prns, dops, ms, n = self._search_args(row)
        raw = self.raw[int(row["band"])][offset:offset + 2 * n]
        q = ref_acq.surface(sig, raw, self.fs, float(row["coffset"]), prns,
                            dops, ms, self.device, precision)
        return ref_acq.results_of(sig, q, prns, dops)

    def check(self, limits):
        """({number compared: value}, {what was checked: count}) of the
        window's searches: each repeat of a search on one epoch against
        its first, and a sample of the epochs, drawn from the seed, with
        every repeat of each against the float64 reference.  A reported
        cell ties with its row's best within metric_err's limit."""
        tie = float(limits["metric_err"])
        groups = {}
        for i, path, off, res in self.done:
            groups.setdefault((i, path, off), []).append(res)
        repeat = sum(sum(r != rs[0] for r in rs[1:])
                     for rs in groups.values())
        keys = sorted(groups)
        pick = self.rng().permutation(len(keys))[:int(
            self.traffic["check_searches"])]
        err = 0.0
        wrong = missing = 0
        for j in sorted(pick):
            i, _path, off = keys[j]
            row = self.rows[i]
            sig, prns, dops, ms, n = self._search_args(row)
            raw = self.raw[int(row["band"])][off:off + 2 * n]
            q = ref_acq.surface(sig, raw, self.fs, float(row["coffset"]),
                                prns, dops, ms, self.device)
            of = ref_acq.judge(sig, q, prns, dops, tie)
            for res in groups[keys[j]]:
                e, w, m = of(res)
                err, wrong, missing = max(err, e), wrong + w, missing + m
            del q
        return ({"metric_err": err, "cells_wrong": wrong,
                 "rows_missing": missing, "repeats_differ": repeat},
                {"searches_checked": len(pick) and sum(
                    len(groups[keys[j]]) for j in pick)})


ENTRY = Acquire
