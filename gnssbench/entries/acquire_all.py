"""Entry `acquire_all`: the acquire-all.sh deployment, one search after
another through the acquire CLI (cli/acquire.main) as
cli/workload.run_acquire_all runs them: the configuration's rows in
order, cycled, each a request; a pass is one round of the rows with one
band-upload cache (the CLI's x_cache), fresh at the pass's start.  Pass
p reads the epoch files of epoch p mod E: each band's capture cut at
epoch_ms epochs into files of file_ms (what the CLI reads for --time),
written once in set-up.  The warm-up is one whole pass.

After the window every repeat of a (row, epoch) search is held to its
first, and check_searches of them, drawn from the seed on distinct rows,
are judged against the float64 reference of
gnssbench/reference/acquire_all.py: in each, every code row (or FDMA
channel) that holds a satellite of the sky and check_rows more drawn
from the seed, each row's surface computed one doppler at a time; every
row of the search must be reported once."""

from __future__ import annotations

import contextlib
import time

from gnssbench import synth
from gnssbench.entries.acquire import Acquire
from gnssbench.reference import acquire_all as rall
from gnssbench.workload import PROGRAM, draw_sky


class AcquireAll(Acquire):

    def setup(self):
        cfg, tr = self.config, self.traffic
        self.rows = cfg["acquire"]
        sky = draw_sky(cfg, self.seed)
        seconds = float(cfg["acquire_capture_s"])
        bands = sorted({int(r["band"]) for r in self.rows})
        self.raw = {b: synth.synth_band(sky.get(b, []), self.fs, seconds,
                                        self.seed, b, self.device)
                    for b in bands}
        step = int(self.fs * tr["epoch_ms"] / 1000)
        nfile = int(self.fs * tr["file_ms"] / 1000)
        self.epochs = []              # [{band: (file, byte offset)}]
        for s0 in range(0, int(seconds * self.fs) - nfile + 1, step):
            e = len(self.epochs)
            self.epochs.append({b: (self.write(
                f"band{b}_epoch{e}.iq", raw[2 * s0:2 * (s0 + nfile)]), 2 * s0)
                for b, raw in self.raw.items()})
        self.sky = [dict(s, band=b) for b, ss in sky.items() for s in ss]
        self.cells = [self.search_cells(r) for r in self.rows]
        self.done = []                # (row, path, offset, results)
        self.cache = {}
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
                self._got.extend((r.prn, r.doppler, r.metric, r.code_offset)
                                 for r in out)
                return out
            return run
        where = f"{PROGRAM}.cli.acquire"
        self.patches.wrap(where, "acquire_signal", capture)
        self.patches.wrap(where, "acquire_signal_fdma", capture)

    def _one(self, i, epoch):
        from gnss_dsp_tpu_torch.cli import acquire as acq_cli

        row = self.rows[i]
        path, offset = self.epochs[epoch][int(row["band"])]
        self._got = []
        t0 = time.perf_counter()
        if self.control == "tf32-reference":
            sig, ids, dops, ms, n = self._search_args(row)
            raw = self.raw[int(row["band"])][offset:offset + 2 * n]
            self._got = rall.results(sig, raw, self.fs, float(row["coffset"]),
                                     ids, dops, ms, row["lags"], self.device,
                                     "tf32")
        else:
            argv = list(row.get("argv", [])) + [
                path, str(int(self.fs)), str(row["coffset"]),
                "--device", str(self.device)]
            with contextlib.redirect_stdout(self.sink):
                rc = acq_cli.main(row["signal"], argv, x_cache=self.cache)
            self.sink.flush()
            if rc != 0:
                raise RuntimeError(f"acquire {row['signal']} exited {rc}")
        self.searches.append(time.perf_counter() - t0)
        self.done.append((i, path, offset, list(self._got)))

    def warm(self):
        for k in range(len(self.rows)):
            self.request(k)
        self.done.clear()
        self.searches.clear()
        self._prev = None

    def request(self, k):
        i, p = k % len(self.rows), k // len(self.rows)
        if i == 0:
            self.cache = {}          # one band upload a pass
        self._one(i, p % len(self.epochs))
        return float(self.cells[i])

    def judged_rows(self, row, ids, rng):
        """The rows of a search that the check judges: every one holding a
        satellite of the sky, and check_rows more drawn with rng."""
        held = [int(s["prn"]) for s in self.sky
                if s["signal"] == row["signal"]
                and int(s["band"]) == int(row["band"])
                and float(s["coffset"]) == float(row["coffset"])]
        held = [i for i in ids if i in held]
        rest = [i for i in ids if i not in held]
        more = rng.permutation(len(rest))[:int(self.traffic["check_rows"])]
        return held + [rest[j] for j in sorted(more)]

    def check(self, limits):
        """({number compared: value}, {what was checked: count}) of the
        window's searches: every repeat of a search on one epoch against
        its first, and check_searches of them, on distinct rows drawn
        from the seed, against the float64 reference (their rows as
        judged_rows picks them).  A reported cell ties with its row's
        best within metric_err's limit."""
        tie = float(limits["metric_err"])
        groups = {}
        for i, path, off, res in self.done:
            groups.setdefault((i, path, off), []).append(res)
        repeat = sum(sum(r != rs[0] for r in rs[1:])
                     for rs in groups.values())
        keys = sorted(groups)
        rng = self.rng()
        picked, rows_seen = [], set()
        for j in rng.permutation(len(keys)):
            if keys[j][0] not in rows_seen and len(picked) < int(
                    self.traffic["check_searches"]):
                rows_seen.add(keys[j][0])
                picked.append(keys[j])
        err = 0.0
        wrong = missing = judged = 0
        for key in sorted(picked):
            i, _path, off = key
            row = self.rows[i]
            sig, ids, dops, ms, n = self._search_args(row)
            raw = self.raw[int(row["band"])][off:off + 2 * n]
            rows = self.judged_rows(row, ids, rng)
            e, w, m = rall.judge(sig, raw, self.fs, float(row["coffset"]),
                                 rows, dops, ms, row["lags"], self.device,
                                 tie, ids, groups[key][0])
            err, wrong, missing = max(err, e), wrong + w, missing + m
            judged += len(rows)
        return ({"metric_err": err, "cells_wrong": wrong,
                 "rows_missing": missing, "repeats_differ": repeat},
                {"searches_checked": len(picked), "rows_judged": judged,
                 "searches_done": len(self.done)})


ENTRY = AcquireAll
