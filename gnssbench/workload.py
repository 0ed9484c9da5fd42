"""What the entries share: the sky drawn from the seed, the request
loop's contract, and the tracking entries' captures, row capture and
reference pass.

A traffic file names its `entry`, a file of gnssbench/entries/ whose
ENTRY class drives the program's entry point the window times, and its
parameters; the configuration says which searches and channels there
are, on which bands, and the sky the captures hold.  An entry
synthesises its captures on the card from the seed, writes them under
the run's temporary directory as the program's users hold them, warms
every shape it will use, then runs one request after another (a closed
loop with one request in flight), and after the window judges what the
timed requests produced against the plain reference.

Faults and controls (`fault`, `control`) replace a layer of the timed
path underneath for the benchmark's own tests and calibration; a
driver's run never sets them.
"""

from __future__ import annotations

import os

import numpy as np

from gnssbench import synth
from gnssbench.reference.models import get_signal as ref_signal
from gnssbench.reference.track import run as ref_track

PROGRAM = "gnss_dsp_tpu_torch"


def load_program(modules):
    """Import the program's modules an entry and the spans reach, all of
    them before the first wrapper goes in, so that no module binds a
    wrapper by `from x import f` while it is in place."""
    import importlib

    for m in modules:
        importlib.import_module(m)


def draw_sky(config: dict, seed: int) -> dict:
    """{band: [seed dicts]}: the configuration's fixed seeds, or a sky
    drawn from the run's seed as its `sky` says (distinct PRNs, doppler
    and code phase uniform, rounded as the golden seeds are written,
    C/N0 uniform)."""
    sky = config["sky"]
    out = {}
    for s in sky.get("fixed", []):
        out.setdefault(int(s["band"]), []).append(dict(s))
    for r in sky.get("random", []):
        rng = np.random.default_rng([int(seed), 7919])
        sig = ref_signal(r["signal"])
        prns = sig.prns(r.get("prns"))
        pick = rng.choice(len(prns), size=int(r["satellites"]),
                          replace=False)
        dop = rng.uniform(*r["doppler_hz"], size=len(pick))
        cp = rng.uniform(0.0, sig.code_length, size=len(pick))
        cn0 = rng.uniform(*r["cn0_dbhz"], size=len(pick))
        for i, k in enumerate(pick):
            out.setdefault(int(r["band"]), []).append(dict(
                signal=r["signal"], prn=int(prns[k]),
                doppler=round(float(dop[i]), 1),
                code_phase=round(float(cp[i]), 2) % sig.code_length,
                coffset=float(r["coffset"]), cn0=float(cn0[i])))
    return out


class Entry:
    """One cell's requests.  Subclasses set MODULES (the program's
    modules they reach) and define setup, warm, request (the work units
    one request completed: cells, channel-samples) and check(limits)."""

    def __init__(self, config, traffic, seed, tmp, patches, device,
                 fault=None, control=None):
        self.device = device
        self.config, self.traffic = config, traffic
        # any whole number: numpy's generators take only non-negative seeds
        self.seed = int(seed) % (1 << 64)
        self.tmp, self.patches = tmp, patches
        self.fault, self.control = fault, control
        self.fs = float(config["fs"])
        self.sink = open(os.path.join(tmp, "rows.txt"), "w")
        self.searches = []            # (wall s) of every search, in order

    def close(self):
        self.sink.close()

    def rng(self):
        return np.random.default_rng([self.seed, 104729])

    def write(self, name, raw: np.ndarray) -> str:
        path = os.path.join(self.tmp, name)
        raw.tofile(path)
        return path


class Tracking(Entry):
    """What the receiver and the track CLI share: the captures, the rows
    captured at track/driver.emit_rows, the reference pass.  `mixed`: the
    pass takes the mixed-signal set-up (the receiver's), or one
    signal's (the track CLI's)."""
    MODULES = (f"{PROGRAM}.track.driver", f"{PROGRAM}.track.receiver",
               f"{PROGRAM}.cli.track")
    mixed = True

    def setup(self):
        cfg = self.config
        sky = draw_sky(cfg, self.seed)
        seconds = float(cfg["track_capture_s"])
        self.bands = sorted({int(c["band"]) for c in self.channels(sky)})
        self.raw = {b: synth.synth_band(sky.get(b, []), self.fs, seconds,
                                        self.seed, b, self.device)
                    for b in self.bands}
        self.paths = {b: self.write(f"band{b}.iq", self.raw[b])
                      for b in self.bands}
        self.chans = self.channels(sky)
        self.samples = float(sum(len(self.raw[int(c["band"])]) // 2
                                 for c in self.chans))
        self.passes = []              # [(rows_f, rows_i)] per pass, chunks
        self._chunks = None
        self._install()

    def channels(self, sky):
        """The channel dicts (signal, band, prn, doppler, code_phase,
        coffset): the configuration's, or every seed of the sky where it
        says "sky"."""
        chans = self.config["track"]
        if chans == "sky":
            return [dict(c, band=b) for b in sorted(sky) for c in sky[b]]
        return [dict(c) for c in chans]

    def _install(self):
        from gnssbench.reference.track import engine as ref_engine

        def capture(fn):
            def run(channels, n_emit, emit, rows_f, rows_i, nb):
                self._chunks.append((rows_f.cpu().numpy(),
                                     rows_i.cpu().numpy()))
                return fn(channels, n_emit, emit, rows_f, rows_i, nb)
            return run
        for where in ("track.driver", "track.receiver"):
            self.patches.wrap(f"{PROGRAM}.{where}", "emit_rows", capture)

        def scan(fn):
            def run(x, chunk_len, code_tab, state, params, n_blocks, **kw):
                if self.control == "float32-sums":
                    args, ovl = ref_engine.scan_args(
                        x, chunk_len, code_tab, state, _ref_params(params),
                        n_blocks, kw.get("ratios"), kw.get("coffset_df"),
                        kw.get("sigp"), kw.get("overlay"))
                    st, rf, ri = ref_engine.track_scan_plain(
                        *args, ovl, sum_dtype=torch.float32)
                    st = type(state)(*st)
                else:
                    st, rf, ri = fn(x, chunk_len, code_tab, state, params,
                                    n_blocks, **kw)
                self._calls += 1
                if self.fault == "stale" and self._calls == 1:
                    return state, rf, ri
                if self.fault == "half":
                    ri = ri.clone()
                    ri[:, ri.shape[1] // 2:, 0] = 0
                elif self.fault == "alter" and rf.shape[0] > 10:
                    rf = rf.clone()
                    rf[10, 0, 3] += 1.0
                return st, rf, ri
            return run
        if self.fault or self.control:
            import torch

            for where in ("track.driver", "track.receiver"):
                self.patches.wrap(f"{PROGRAM}.{where}", "track_scan", scan)

    def warm(self):
        self.request(0)
        self.passes.clear()

    def request(self, k):
        self._chunks = []
        self._calls = 0
        self.run_pass()
        rf = np.concatenate([f for f, _i in self._chunks])
        ri = np.concatenate([i for _f, i in self._chunks])
        self.passes.append(ref_track.per_channel(rf, ri))
        return self.samples

    def check(self, limits):
        """({number compared: value}, {what was checked: count}): every
        pass of the window against one reference pass over the same
        captures, row for row and bit for bit."""
        bands = [(self.raw[b], [c for c in self.chans if int(c["band"]) == b])
                 for b in self.bands]
        want = ref_track.track_pass(bands, self.fs, self.mixed, self.device,
                                    tuple(self.traffic["loop_dwells"]))
        differ = sum(ref_track.rows_differ(p, want) for p in self.passes)
        rows = sum(len(f) for f, _i in want)
        return ({"rows_differ": differ},
                {"passes_checked": len(self.passes), "rows_checked": rows})


def _ref_params(p):
    """The program's TrackParams as the frozen engine's (same fields)."""
    from gnssbench.reference.track.engine import TrackParams

    return TrackParams(**p._asdict())
