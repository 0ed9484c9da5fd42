"""The program's spans and counters (utils/profiling) on the CPU:

  * off (no profiler, no GNSS_DSP_TIMING): a shared no-op, no record, no
    record_function, no CUDA event and no synchronise;
  * under profiling.trace: the acquire and track CLIs' spans with their
    parents, request ids and self times, each span in the exported
    Chrome trace with its recorded duration (within 5% or 0.5 ms);
  * the code-spectra LRU's hit and miss counters, h2d.bytes against the
    bytes uploaded;
  * a CUDA device's event pair and the GNSS_DSP_TIMING synchronise,
    against stand-ins for torch.cuda's events and synchronise;
  * GNSS_DSP_TIMING's numbers and the receiver's stats walls against the
    call's span totals;
  * threads: spans of the thread that runs the profiler or the timed
    call, each timed call's own under contention.
"""

import contextlib
import io
import json
import re
import sys
import threading

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.acquire import engine
from gnss_dsp_tpu_torch.cli import acquire as acq_cli
from gnss_dsp_tpu_torch.cli import track as trk_cli
from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.ops import cplx
from gnss_dsp_tpu_torch.track import receiver
from gnss_dsp_tpu_torch.track.driver import TrackChannel
from gnss_dsp_tpu_torch.utils import profiling
from gnss_dsp_tpu_torch.utils.synth import synth_iq, to_int8_iq

FS = 4.096e6
PLANTS = ((3, 1000.0, 211.6), (9, -500.0, 803.3))
ACQ = ["--prn", "3,9", "--doppler-search", "-1500,1500,500", "--time", "8"]
TRACK = ["--blocks", "12", "--chunk-ms", "5"]
SPEC = "3:1000.0:211.6,9:-500.0:803.3"
TRACK_SPANS = {"cli.track", "track.file", "track.setup", "track.refill",
               "track.read_wait", "track.assemble", "upload", "track.scan",
               "track.rows", "track.readback"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def env(monkeypatch):
    for name in ("GNSS_DSP_TIMING", "GNSS_DSP_CPU", "GNSS_DSP_NO_PALLAS",
                 "GNSS_DSP_UPLOAD_INT4", "GNSS_DSP_NO_FUSED",
                 "GNSS_DSP_PALLAS_V1"):
        monkeypatch.delenv(name, raising=False)
    profiling.reset()
    yield monkeypatch
    profiling.reset()


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """40 ms of GPS L1 at 4.096 MHz, two PRNs at 45 dB-Hz, int8 I/Q."""
    sig = get_signal("gps-l1")
    n = int(FS * 0.040)
    rng = np.random.default_rng(19)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in PLANTS:
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, FS, n,
                      doppler_hz=dop, code_phase=cp, cn0_dbhz=45.0,
                      carrier_ratio=sig.carrier_ratio, rng=rng)
    path = tmp_path_factory.mktemp("spans") / "gps_l1.iq"
    path.write_bytes(to_int8_iq(x, scale=16.0))
    return str(path)


def _run(main, *args):
    """stderr of main(*args), its stdout dropped."""
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert main(*args) == 0
    return err.getvalue()


def _acquire(path):
    return _run(acq_cli.main, "gps-l1",
                ACQ + [path, str(FS), "0", "--device", "cpu"])


def _track(path, signal="gps-l1", spec=SPEC):
    return _run(trk_cli.main, signal,
                TRACK + [path, str(FS), "0", spec, "--device", "cpu"])


def _refuse(*_a, **_k):
    raise AssertionError("called while nothing records")


def test_off_is_a_shared_no_op(env, capture):
    """With no profiler and no GNSS_DSP_TIMING a span is one shared
    object per name that records nothing and touches no CUDA event,
    synchronise or record_function, even given a CUDA device; counts
    count nothing; the CLIs run so and keep nothing."""
    for where, name in ((torch.cuda, "Event"), (torch.cuda, "synchronize"),
                        (torch.cuda, "current_stream"),
                        (torch.profiler, "record_function"),
                        (profiling, "_record_function")):
        env.setattr(where, name, _refuse)
    assert profiling.span("upload") is profiling.span("upload",
                                                      device="cuda")
    with profiling.span("upload", device=torch.device("cuda")):
        profiling.count("h2d.bytes", 7)
    _acquire(capture)
    _track(capture)
    assert profiling.spans() == [] and profiling.counts() == {}
    assert profiling.totals() == {}


def _children(spans):
    kids = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(id(s.parent), []).append(s)
    return kids


def test_cli_spans_under_trace(env, capture, tmp_path):
    """Under profiling.trace: the acquire CLI's spans under its root and
    the track CLI's under theirs, each call one request; self time is the
    span less its children; every span is in the Chrome trace with its
    recorded duration."""
    env.setattr(engine, "_CODE_FFTS_DEV", {})
    with profiling.trace(str(tmp_path / "tr")):
        _acquire(capture)
        _track(capture)
    spans = profiling.spans()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    (acq,) = by["cli.acquire"]
    (trk,) = by["cli.track"]
    assert acq.parent is None and trk.parent is None
    assert acq.request != trk.request
    for s in spans:
        root = s
        while root.parent is not None:
            assert root.parent.t0 <= root.t0 <= root.t1 <= root.parent.t1
            root = root.parent
        assert s.request == root.request
    assert {s.name for s in spans if s.request == acq.request} == {
        "cli.acquire", "acquire.read", "upload", "frontend",
        "acq.code_spectra", "acq.mix_fft"}
    assert {s.name for s in spans if s.request == trk.request} == \
        TRACK_SPANS
    for name in ("acquire.read", "upload", "frontend", "acq.code_spectra",
                 "acq.mix_fft"):
        assert by[name][0].parent is acq
    (tf,) = by["track.file"]
    assert tf.parent is trk
    assert all(s.parent is tf for s in by["track.refill"] + by["track.scan"]
               + by["track.assemble"] + by["track.rows"] + by["upload"][1:])
    assert all(s.parent.name == "track.refill" for s in by["track.read_wait"])
    assert all(s.parent.name == "track.rows" for s in by["track.readback"])
    assert len(by["track.scan"]) == len(by["track.rows"]) >= 2
    kids = _children(spans)
    tot = profiling.totals()
    for name, group in by.items():
        host = sum(s.t1 - s.t0 for s in group) / 1e9
        own = sum(s.t1 - s.t0 - sum(k.t1 - k.t0 for k in kids.get(id(s), []))
                  for s in group) / 1e9
        t = tot[name]
        assert t.calls == len(group) and t.stream_s is None
        assert t.host_s == pytest.approx(host, abs=1e-9)
        assert t.self_s == pytest.approx(own, abs=1e-9)
        assert 0.0 <= t.self_s <= t.host_s
    events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    for name, group in by.items():
        got = sorted(e["dur"] for e in events
                     if e.get("name") == name and e.get("ph") == "X")
        want = sorted((s.t1 - s.t0) / 1e3 for s in group)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert abs(g - w) <= max(0.05 * w, 500.0), (name, g, w)


def test_lru_counters_and_uploaded_bytes(env, capture, tmp_path):
    """A first search misses the code-spectra LRU and a second hits it;
    h2d.bytes is the bytes the uploads handed over (int8, and int4 packed
    on the host first)."""
    env.setattr(engine, "_CODE_FFTS_DEV", {})
    with profiling.trace(str(tmp_path / "a")):
        _acquire(capture)
        first = profiling.counts()
        _acquire(capture)
    assert first == {"acq.code_ffts.miss": 1, "acq.route.v2": 1,
                     "h2d.bytes": 2 * int((8 + 5) * FS / 1000)}
    c = profiling.counts()
    assert c["acq.code_ffts.miss"] == 1 and c["acq.code_ffts.hit"] == 1
    raw = np.arange(-50, 50, dtype=np.int8)
    with profiling.trace(str(tmp_path / "b")):
        cplx.from_int8_iq(raw.tobytes(), pad=8, device="cpu")
        packed = cplx.pack_int4_host(raw)
        cplx.from_int4_iq(packed, device="cpu")
        cplx.from_int4_iq(bytes(6), device="cpu")
    assert packed.nbytes == 50
    assert profiling.counts() == {"h2d.bytes": 100 + 50 + 6}
    assert profiling.totals()["upload"].calls == 3


class _Event:
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None
        _Event.made.append(self)

    def record(self, stream=None):
        self.at = len(_Event.made)
        self.stream = stream

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 2.5                          # ms


def test_cuda_events_and_timing_synchronise(env, tmp_path):
    """A span given a CUDA device records an event pair on its stream
    while it records and totals() sums their elapsed times; it
    synchronises only where a GNSS_DSP_TIMING call names it and the line
    prints, not while the profiler alone records nor for a caller's
    stats."""
    synced = []
    _Event.made = []
    env.setattr(torch.cuda, "Event", _Event)
    env.setattr(torch.cuda, "current_stream", lambda dev=None: ("s", dev))
    env.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))
    cuda = torch.device("cuda")
    with profiling.trace(str(tmp_path / "t")):
        for _ in range(2):
            with profiling.span("upload", device=cuda):
                pass
        with profiling.span("frontend", device="cpu"):
            pass
    t = profiling.totals()
    assert t["upload"].stream_s == pytest.approx(2 * 2.5e-3)
    assert t["frontend"].stream_s is None
    n_traced = len(profiling.spans())
    assert len(_Event.made) == 4 and not synced
    assert all(e.stream == ("s", cuda) for e in _Event.made)
    with profiling.Timing("upload", keep=True) as kept:
        with profiling.span("upload", device=cuda):
            pass
    assert not synced and kept.seconds("upload") >= 0.0
    env.setenv("GNSS_DSP_TIMING", "1")
    with profiling.Timing("upload") as timed:
        with profiling.span("upload", device=cuda):
            pass
        with profiling.span("frontend", device=cuda):
            pass
    assert synced == [cuda] and timed.printing
    assert [s.name for s in timed.spans] == ["upload", "frontend"]
    assert len(profiling.spans()) == n_traced == 3


def _line(err, label):
    (line,) = [ln for ln in err.splitlines() if label in ln]
    return [float(v) for v in re.findall(r"\d+\.\d+", line)]


def test_timing_lines_are_the_span_totals(env, capture, tmp_path):
    """With GNSS_DSP_TIMING set, the acquire CLI's and track_file's
    numbers are the call's span totals to their printed precision (the
    profiler records the same spans alongside)."""
    env.setenv("GNSS_DSP_TIMING", "1")
    with profiling.trace(str(tmp_path / "a")):
        err = _acquire(capture)
    t = profiling.totals()
    ru, fe = _line(err, "read+upload")
    (search,) = _line(err, ": search")
    assert ru == round(t["acquire.read"].host_s + t["upload"].host_s, 2)
    assert fe == round(t["frontend"].host_s, 2)
    engine_s = sum(t[k].host_s for k in ("acq.code_spectra", "acq.mix_fft")
                   if k in t)
    assert 0.0 <= search <= t["cli.acquire"].self_s + engine_s + 0.005
    with profiling.trace(str(tmp_path / "t")):
        err = _track(capture)
    t = profiling.totals()
    rw, up, sr = _line(err, "[track_file timing]")
    assert rw == round(t["track.refill"].host_s, 2)
    assert up == round(t["track.assemble"].host_s + t["upload"].host_s, 2)
    assert sr == round(t["track.scan"].host_s + t["track.rows"].host_s, 2)


@pytest.mark.parametrize("timing", [False, True])
def test_receiver_stats_are_the_span_totals(env, capture, tmp_path, timing):
    """The receiver's stats walls are its spans: read wait the refills,
    upload the assembly and the uploads, scan and rows the scans and the
    rows; with GNSS_DSP_TIMING its line prints them."""
    if timing:
        env.setenv("GNSS_DSP_TIMING", "1")
    data = open(capture, "rb").read()
    sig = get_signal("gps-l1")
    bands = [(io.BytesIO(data), [sig], [TrackChannel(prn=p, doppler=d,
                                                     code_offset=cp)],
              [0.0]) for p, d, cp in PLANTS]
    stats, err = {}, io.StringIO()
    with profiling.trace(str(tmp_path / "r")), \
            contextlib.redirect_stderr(err):
        receiver.track_receiver(bands, FS, loop_dwells=(8, 8),
                                chunk_ms=5.0, max_blocks=12, device="cpu",
                                stats=stats)
    t = profiling.totals()
    assert t["track.receiver"].calls == 1 and stats["chunks"] >= 2
    assert t["track.assemble"].calls == stats["chunks"]
    assert stats["t_read"] == pytest.approx(t["track.refill"].host_s)
    assert stats["t_upload"] == pytest.approx(
        t["track.assemble"].host_s + t["upload"].host_s)
    assert stats["t_scan"] == pytest.approx(
        t["track.scan"].host_s + t["track.rows"].host_s)
    lines = [ln for ln in err.getvalue().splitlines() if "timing" in ln]
    if timing:
        assert _line(err.getvalue(), "[track_receiver timing]") == [
            round(stats[k], 2) for k in ("t_read", "t_upload", "t_scan")]
    else:
        assert lines == []


def test_nested_span_of_its_own_name_adds_nothing(env, capture, tmp_path):
    """`track multi` through track's main, the int4 upload and a span in
    one of its own name: the outer span alone is recorded."""
    with profiling.trace(str(tmp_path / "m")):
        _track(capture, "multi", "gps-l1:3:1000.0:211.6")
        with profiling.span("x"):
            with profiling.span("x"):
                with profiling.span("y"):
                    pass
    t = profiling.totals()
    assert t["cli.track"].calls == 1 and t["x"].calls == 1
    (y,) = [s for s in profiling.spans() if s.name == "y"]
    assert y.parent.name == "x" and y.parent.parent is None


def test_decorator_opens_its_span_at_each_call(env, tmp_path):
    """A function decorated while nothing records, or while the profiler
    records, opens its span at each call and only while something
    records."""
    def f(v):
        with profiling.span("inner"):
            return v + 1
    off_made = profiling.span("deco")(f)
    with profiling.trace(str(tmp_path / "d")):
        on_made = profiling.span("deco")(f)
        assert off_made(1) == on_made(1) == 2
    assert on_made(2) == off_made(2) == 3
    t = profiling.totals()
    assert t["deco"].calls == 2 and t["inner"].calls == 2
    assert off_made.__name__ == "f"


def test_spans_of_their_own_thread(env, tmp_path):
    """Spans record on the thread that runs the profiler or the
    GNSS_DSP_TIMING call only; calls timed on many threads at once each
    keep exactly their own spans and counts."""
    seen = []

    def other():
        seen.append(type(profiling.span("t")).__name__)
        profiling.count("c")
    with profiling.trace(str(tmp_path / "th")):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        with profiling.span("main"):
            pass
    assert not th.is_alive() and seen == ["_Off"]
    assert [s.name for s in profiling.spans()] == ["main"]
    assert profiling.counts() == {}

    env.setenv("GNSS_DSP_TIMING", "1")
    n_threads, n = 16, 200
    kept = {}

    def work(k):
        with profiling.Timing() as timed:
            for _ in range(n):
                with profiling.span(f"root{k}"):
                    with profiling.span("leaf"):
                        profiling.count("c")
        kept[k] = timed
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    for k, timed in kept.items():
        assert timed.counts == {"c": n}
        assert len(timed.spans) == 2 * n
        leaves = [s for s in timed.spans if s.name == "leaf"]
        assert all(s.parent.name == f"root{k}"
                   and s.request == s.parent.request for s in leaves)
        assert len({s.request for s in timed.spans}) == n
    assert len(kept) == n_threads


def test_code_generator_counters_and_span(env, tmp_path):
    """One E5aI code row under the profiler: its two registers' chips
    counted, all but each register's stepped prefix written by the
    recurrence, inside spans `codes.lfsr`."""
    sig = get_signal("galileo-e5ai")
    with profiling.trace(str(tmp_path / "c")):
        row = sig.code_table((24,))
    c = profiling.counts()
    assert row.shape == (1, 10230)
    assert c["codes.lfsr.chips"] == 2 * row.size
    assert c["codes.lfsr.chips_stepped"] == 2 * 14
    assert c["codes.lfsr.chips_stepped"] < 0.1 * c["codes.lfsr.chips"]
    spans = [s for s in profiling.spans() if s.name == "codes.lfsr"]
    assert len(spans) == 2 and all(s.parent is None for s in spans)
    assert profiling.totals()["codes.lfsr"].calls == 2


def _coherent_names(counts, totals):
    return sorted(k for k in list(counts) + list(totals)
                  if k.startswith(("acq.coh.", "acq.route.coh_")))


def test_coherent_search_spans_and_counters(env, capture, tmp_path):
    """A small B1I --coherent 20 search (the spec route, one doppler
    chunk of 2, one group of 20 alignments) records the span
    acq.coh.combine inside cli.acquire, acq.coh.rows = dc x G x A and
    exactly one acq.route.coh_spec; a non-coherent search records none of
    them."""
    env.setattr(engine, "_CODE_FFTS_DEV", {})
    path = tmp_path / "b1i.iq"
    rng = np.random.default_rng(5)
    path.write_bytes(rng.integers(-20, 21, size=2 * 204800,
                                  dtype=np.int8).tobytes())
    with profiling.trace(str(tmp_path / "coh")):
        _run(acq_cli.main, "beidou-b1i",
             ["--coherent", "20", "--time", "20", "--prn", "7",
              "--doppler-search", "0,50,25", str(path), "8192000", "0",
              "--device", "cpu"])
    c, tot = profiling.counts(), profiling.totals()
    assert _coherent_names(c, tot) == ["acq.coh.combine", "acq.coh.rows",
                                       "acq.route.coh_spec"]
    assert c["acq.route.coh_spec"] == 1
    assert c["acq.coh.rows"] == 2 * 1 * 20
    (comb,) = [s for s in profiling.spans() if s.name == "acq.coh.combine"]
    assert comb.parent.name == "cli.acquire"
    assert tot["acq.coh.combine"].stream_s is None          # the CPU
    with profiling.trace(str(tmp_path / "plain")):
        _acquire(capture)
    assert _coherent_names(profiling.counts(), profiling.totals()) == []
