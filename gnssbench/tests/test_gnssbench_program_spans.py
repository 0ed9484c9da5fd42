"""The readers of the program's own spans and counters
(gnss_dsp_tpu_torch.utils.profiling) on planted records: shares of the
window from host and self seconds, GB/s from bytes and stream seconds,
the LRU's hit ratio, and nothing where the program recorded nothing or
has no such registry (a tree before it)."""

import json
import os
import types

import pytest

from gnss_dsp_tpu_torch.utils import profiling
from gnssbench import run as harness
from gnssbench.tests import tiny

WINDOW = 10.0


def _spec():
    return json.load(open(os.path.join(tiny.ROOT, "BENCHMARK.json")))


PROGRAM = ("file_read_share.acq", "upload_host_share.acq", "h2d_gbps.acq",
           "frontend_host_share.acq", "code_ffts_hit_ratio.acq",
           "read_wait_share.track", "refill_share.track",
           "assemble_share.track", "upload_host_share.track",
           "h2d_gbps.track", "rows_format_share.track", "setup_share.track",
           "pass_self_share.track")


class _Event:
    """A CUDA event of a span: elapsed_time gives the span's stream ms."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return self.ms


def _span(name, t0, t1, parent=None, stream_ms=None):
    """A closed span as the registry keeps it, times in seconds."""
    return types.SimpleNamespace(
        name=name, parent=parent, request=1, t0=int(t0 * 1e9),
        t1=int(t1 * 1e9),
        events=None if stream_ms is None else (_Event(stream_ms),
                                                _Event(stream_ms)))


@pytest.fixture
def planted(monkeypatch):
    """Plant spans and counts in the program's registry."""
    spans, counts = [], {}
    monkeypatch.setattr(profiling._traced, "spans", spans)
    monkeypatch.setattr(profiling._traced, "counts", counts)
    return spans, counts


@pytest.fixture(scope="module")
def readers():
    metrics = {m["name"]: m for m in _spec()["per_layer"]}
    return {name: harness.Cell(metrics[name]["workloads"][0]).reader(
        "metrics", metrics[name]) for name in PROGRAM}


def _read(readers, name):
    return readers[name].read(harness.Layers(None, {}, WINDOW, None))


def test_every_new_metric_reads_the_program(readers):
    """The thirteen metrics are in BENCHMARK.json, each with its file,
    its cells and the end-to-end metric of those cells."""
    spec = _spec()
    assert len(readers) == 13
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        if m["name"] in PROGRAM:
            assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])


def test_nothing_recorded_reads_nothing(readers, planted, monkeypatch):
    """No span or counter: every reader gives None; a registry without
    totals() (a tree before it): None as well, no exception."""
    for name in PROGRAM:
        assert _read(readers, name) is None, name
    monkeypatch.delattr(profiling, "totals")
    for name in PROGRAM:
        assert _read(readers, name) is None, name


def test_acquisition_shares_gbps_and_hits(readers, planted):
    spans, counts = planted
    root = _span("cli.acquire", 0.0, 5.0)
    spans += [_span("acquire.read", 0.0, 1.0, root),
              _span("upload", 1.0, 1.5, root, stream_ms=200.0),
              _span("upload", 2.0, 2.5, root, stream_ms=300.0),
              _span("frontend", 2.5, 3.25, root), root]
    counts.update({"h2d.bytes": 4_000_000_000, "acq.code_ffts.hit": 3,
                   "acq.code_ffts.miss": 1})
    assert _read(readers, "file_read_share.acq") == pytest.approx(10.0)
    assert _read(readers, "upload_host_share.acq") == pytest.approx(10.0)
    assert _read(readers, "h2d_gbps.acq") == pytest.approx(8.0)
    assert _read(readers, "frontend_host_share.acq") == pytest.approx(7.5)
    assert _read(readers, "code_ffts_hit_ratio.acq") == pytest.approx(75.0)
    counts.pop("acq.code_ffts.hit")
    assert _read(readers, "code_ffts_hit_ratio.acq") == 0.0
    counts.pop("h2d.bytes")
    assert _read(readers, "h2d_gbps.acq") is None


def test_tracking_self_times(readers, planted):
    """refill less its read wait, rows less their read-back, and the
    pass spans' self times summed (the CLI's and track_file's)."""
    spans, _counts = planted
    cli = _span("cli.track", 0.0, 9.0)
    tf = _span("track.file", 0.5, 8.5, cli)
    refill = _span("track.refill", 1.0, 3.0, tf)
    rows = _span("track.rows", 4.0, 7.0, tf)
    spans += [_span("track.setup", 0.5, 0.7, tf),
              _span("track.read_wait", 1.0, 1.5, refill), refill,
              _span("upload", 3.0, 3.5, tf, stream_ms=100.0),
              _span("track.scan", 3.5, 4.0, tf),
              _span("track.readback", 4.0, 4.5, rows), rows, tf, cli]
    assert _read(readers, "read_wait_share.track") == pytest.approx(5.0)
    assert _read(readers, "refill_share.track") == pytest.approx(15.0)
    assert _read(readers, "rows_format_share.track") == pytest.approx(25.0)
    assert _read(readers, "setup_share.track") == pytest.approx(2.0)
    assert _read(readers, "upload_host_share.track") == pytest.approx(5.0)
    assert _read(readers, "assemble_share.track") is None
    # cli.track: 9 - 8 = 1 s; track.file: 8 - (0.2 + 2 + 0.5 + 0.5 + 3)
    assert _read(readers, "pass_self_share.track") == pytest.approx(
        100.0 * (1.0 + 1.8) / WINDOW)
    assert _read(readers, "h2d_gbps.track") is None    # no bytes counted


def test_receiver_assembly_and_pass(readers, planted):
    spans, counts = planted
    rx = _span("track.receiver", 0.0, 8.0)
    spans += [_span("track.assemble", 1.0, 5.0, rx),
              _span("upload", 5.0, 5.5, rx, stream_ms=250.0),
              _span("upload", 6.0, 6.5, rx, stream_ms=250.0), rx]
    counts["h2d.bytes"] = 3_000_000_000
    assert _read(readers, "assemble_share.track") == pytest.approx(40.0)
    assert _read(readers, "pass_self_share.track") == pytest.approx(30.0)
    assert _read(readers, "h2d_gbps.track") == pytest.approx(6.0)
