"""The streaming track ingest (track/driver._PrefetchReader, track_file's
chunk refill, ops/cplx.from_iq with into) on the CPU:

  * a streaming track_file over 6 chunks whose takes straddle two
    staging slots gives the rows of the plain scan over the whole
    capture in one chunk (the preloaded path), bit for bit;
  * under profiling.trace every sample crosses once (h2d.bytes the
    file's bytes) and nothing is pinned on the CPU (h2d.pinned_bytes 0,
    no track.pinned.alloc); GNSS_DSP_UPLOAD_INT4 uploads half the bytes,
    with the rows of the plain scan over the 4-bit samples;
  * the reader's takes hand out views of the slots in order, never more
    than asked, and give a slot back to the worker only once its bytes
    are uploaded; a read error reaches the caller;
  * neither the reader's close nor a track_file stopped by max_blocks
    waits for a read the stream holds (a stalled pipe);
  * the chunk builder both loops share (driver._Chunks), at one band and
    three, int8 and int4: every chunk is the bytes from each band's
    stream position assembled on the host (from_int8_iq, zeros to each
    segment's end), the carried samples moved across the two buffers,
    and each band's rebase is the least pointer of its channels.
"""

import collections
import io
import threading
import time

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.ops import cplx
from gnss_dsp_tpu_torch.track import driver
from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file
from gnss_dsp_tpu_torch.utils import profiling
from gnss_dsp_tpu_torch.utils.synth import synth_iq, to_int8_iq

FS = 4.096e6
PLANTS = ((7, 900.0, 317.25), (13, -2200.0, 5.0))
KEYS = ("block", "p_re", "p_im", "carrier_f", "code_f_offset", "phase_deg",
        "early", "prompt", "late", "code_cyc", "code_p", "carrier_cyc",
        "carrier_p", "samp")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def env(monkeypatch):
    for name in ("GNSS_DSP_TIMING", "GNSS_DSP_UPLOAD_INT4",
                 "GNSS_DSP_NO_FUSED", "GNSS_DSP_PALLAS_V1"):
        monkeypatch.delenv(name, raising=False)
    profiling.reset()
    yield monkeypatch
    profiling.reset()


@pytest.fixture(scope="module")
def capture():
    """63 ms of GPS L1 at 4.096 MHz, two PRNs at 45 dB-Hz, int8 I/Q."""
    sig = get_signal("gps-l1")
    n = int(FS * 0.063)
    rng = np.random.default_rng(23)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in PLANTS:
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, FS, n,
                      doppler_hz=dop, code_phase=cp, cn0_dbhz=45.0,
                      carrier_ratio=sig.carrier_ratio, rng=rng)
    return np.frombuffer(to_int8_iq(x, scale=16.0), np.int8).copy()


def _channels():
    return [TrackChannel(prn=p, doppler=d, code_offset=cp)
            for p, d, cp in PLANTS]


def _table(channels):
    return [np.array([[r[k] for k in KEYS] for r in ch.rows], np.float64)
            for ch in channels]


def _track(fp, **kw):
    chans = _channels()
    track_file(get_signal("gps-l1"), fp, FS, 0.0, chans,
               loop_dwells=(8, 8), device="cpu", **kw)
    return _table(chans)


def _plain(x_dev, n):
    """The plain scan over the whole capture in one chunk (the preloaded
    path: no reader, no refill)."""
    return _track(io.BytesIO(), chunk_ms=100.0, preloaded=(x_dev, n))


def _pad(n):
    pad = int(FS * 0.006) + 16384
    return pad + (-(n + pad)) % 1024


def _parts_seen(env):
    seen = []
    take = driver._PrefetchReader.take

    def spy(self, want):
        got = take(self, want)
        seen.append([len(p) // 2 for p in got or ()])
        assert sum(seen[-1]) <= want
        return got
    env.setattr(driver._PrefetchReader, "take", spy)
    return seen


def test_streaming_rows_are_the_plain_scans(env, capture, tmp_path):
    """10 ms chunks over 63 ms: every take after the first straddles two
    slots, each sample goes up once in each of two calls, and nothing is
    pinned on the CPU."""
    n = len(capture) // 2
    want = _plain(cplx.from_int8_iq(capture, pad=_pad(n), device="cpu"), n)
    seen = _parts_seen(env)
    with profiling.trace(str(tmp_path / "a")):
        got = _track(io.BytesIO(capture.tobytes()), chunk_ms=10.0)
        first = profiling.counts()
        profiling.reset()
        again = _track(io.BytesIO(capture.tobytes()), chunk_ms=10.0)
        second = profiling.counts()
    assert len([s for s in seen if s]) >= 2 * 6
    assert any(len(s) == 2 for s in seen)
    for g, a, w in zip(got, again, want):
        assert len(w) >= 55
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(a, w)
    for c in (first, second):
        assert c["h2d.bytes"] == capture.nbytes
        assert c["h2d.pinned_bytes"] == 0              # no card, no pin
        assert "track.pinned.alloc" not in c


def test_int4_uploads_half_with_the_plain_scans_rows(env, capture,
                                                     tmp_path):
    """GNSS_DSP_UPLOAD_INT4: each new part packed and uploaded into
    place, half the int8 bytes, and the rows of the plain scan over the
    4-bit samples (the carried samples are already unpacked)."""
    n = len(capture) // 2
    x4 = cplx.from_int4_iq(cplx.pack_int4_host(capture), pad=_pad(n))
    want = _plain(x4, n)
    env.setenv("GNSS_DSP_UPLOAD_INT4", "1")
    with profiling.trace(str(tmp_path / "a")):
        got = _track(io.BytesIO(capture.tobytes()), chunk_ms=10.0)
    c = profiling.counts()
    assert 2 * c["h2d.bytes"] == capture.nbytes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _drain(reader, want):
    out = []
    while True:
        parts = reader.take(want)
        if parts is None:
            return out
        out += [bytes(p) for p in parts]
        reader.uploaded()


def test_reader_takes_views_in_order(env):
    """Takes of 5 samples from slots of 7: the stream in order, in parts
    of at most two slots, each a view of a slot (read before it goes
    back: the worker reads into it again); the 23-sample stream ends
    with a short slot."""
    data = np.arange(46, dtype=np.int8).tobytes()
    r = driver._PrefetchReader(io.BytesIO(data), 7)
    try:
        first = r.take(5)
        assert len(first) == 1
        assert any(np.shares_memory(first[0], s.a) for s in r._slots)
        got = [bytes(first[0])]
        r.uploaded()
        second = r.take(5)
        assert [len(p) for p in second] == [4, 6]
        got += [bytes(p) for p in second]
        r.uploaded()
        got += _drain(r, 5)
        assert b"".join(got) == data
        assert r.done and r.take(5) is None
    finally:
        r.close()
    assert _until(lambda: not r._t.is_alive())


def _until(cond, seconds=10.0):
    t = threading.Event()
    for _ in range(int(seconds / 0.01)):
        if cond():
            return True
        t.wait(0.01)
    return cond()


class _Gate:
    """A stand-in for a slot's CUDA event: synchronize() blocks until
    opened."""

    def __init__(self):
        self.waited, self.opened = threading.Event(), threading.Event()

    def synchronize(self):
        self.waited.set()
        assert self.opened.wait(10)


def test_slot_goes_back_only_after_its_upload(env):
    """A slot wholly taken goes back to the worker only when uploaded()
    marks its bytes uploaded, and the worker reads into it only once the
    event recorded then has completed."""
    data = np.arange(200, dtype=np.int8).tobytes()
    r = driver._PrefetchReader(io.BytesIO(data), 5)
    try:
        assert _until(lambda: r._filled.qsize() == 3)   # every slot read
        (part,) = r.take(5)
        (slot,) = r._spent
        assert np.shares_memory(part, slot.a)
        threading.Event().wait(0.2)
        assert r._filled.qsize() == 2 and r._free.empty()
        gate = _Gate()
        r._taken, r._spent = [], []      # as uploaded(), with the event
        slot.event = gate
        r._free.put(slot)
        assert gate.waited.wait(10)
        threading.Event().wait(0.2)
        assert r._filled.qsize() == 2    # no read while the copy runs
        gate.opened.set()
        assert _until(lambda: r._filled.qsize() == 3)
        assert bytes(part) == data[30:40]             # the fourth read
    finally:
        r.close()
    assert _until(lambda: not r._t.is_alive())


class _Broken:
    def readinto(self, buf):
        raise OSError("disk gone")


def test_read_error_reaches_the_take(env):
    r = driver._PrefetchReader(_Broken(), 8)
    try:
        with pytest.raises(OSError, match="disk gone"):
            r.take(8)
        assert r.take(8) is None
    finally:
        r.close()


class _Stalling:
    """A stream that serves `data`, then holds readinto until released:
    a live pipe whose producer stalled."""

    def __init__(self, data):
        self._b = io.BytesIO(data)
        self.held, self.release = threading.Event(), threading.Event()

    def readinto(self, buf):
        n = self._b.readinto(buf)
        if n:
            return n
        self.held.set()
        self.release.wait(30)
        return 0


def test_close_does_not_wait_for_a_held_read(env):
    """Slots of 4 samples over a 10-sample stream that then stalls: the
    worker is held inside its third read, and close returns at once;
    the worker ends when the read returns."""
    s = _Stalling(bytes(20))
    r = driver._PrefetchReader(s, 4)
    try:
        assert [len(p) for p in r.take(4)] == [8]
        r.uploaded()
        assert s.held.wait(10)
        t0 = time.monotonic()
        r.close()
        assert time.monotonic() - t0 < 5
        assert r._t.is_alive()
    finally:
        s.release.set()
    assert _until(lambda: not r._t.is_alive())


def test_max_blocks_returns_on_a_stalled_stream(env, capture):
    """track_file in 10 ms chunks over a stream that serves 40 ms and
    then stalls: it stops at max_blocks with the plain scan's first rows
    while the reader's worker is still held in its read."""
    n = len(capture) // 2
    want = _plain(cplx.from_int8_iq(capture, pad=_pad(n), device="cpu"), n)
    s = _Stalling(capture[:2 * int(FS * 0.040)].tobytes())
    try:
        t0 = time.monotonic()
        got = _track(s, chunk_ms=10.0, max_blocks=15)
        assert time.monotonic() - t0 < 20
        assert s.held.is_set() and not s.release.is_set()
    finally:
        s.release.set()
    for g, w in zip(got, want):
        assert len(g) >= 10
        np.testing.assert_array_equal(g, w[:len(g)])


_Ptr = collections.namedtuple("_Ptr", "ptr")


def _host_segment(raw, pos, n, cap, int4):
    """Band samples [pos, pos + n) from the capture bytes, zeros to cap."""
    part = raw[2 * pos:2 * (pos + n)]
    if int4:
        return cplx.from_int4_iq(cplx.pack_int4_host(part), pad=cap - n,
                                 device="cpu")
    return cplx.from_int8_iq(part, pad=cap - n, device="cpu")


@pytest.mark.parametrize("lens,int4", [
    ((2500,), False),                   # one band: track_file's chunk
    ((2500,), True),
    ((2500, 2310, 2710), False),        # three bands, short last chunks
    ((2500, 900, 2710), True),          # band 1 ends chunks before the rest
])
def test_chunks_are_the_host_assembled_bytes(env, lens, int4):
    """500-sample chunks (nmax 37) over bands of `lens` samples, 2, 1 and
    3 channels a band, their pointers moved on by seed-drawn amounts
    after each chunk: each chunk is each band's next bytes from its
    stream position, assembled on the host, the carried samples moved
    over from the other buffer; rebase drops each band's least pointer
    and moves its channels back by as many."""
    if int4:
        env.setenv("GNSS_DSP_UPLOAD_INT4", "1")
    rng = np.random.default_rng(sum(lens) + int4)
    raws = [rng.integers(-128, 128, 2 * n).astype(np.int8) for n in lens]
    band_of = [b for b, k in enumerate((2, 1, 3)[:len(lens)])
               for _ in range(k)]
    fs, chunk_ms, nmax = 100_000.0, 5.0, 37
    chunks = driver._Chunks([io.BytesIO(r.tobytes()) for r in raws], band_of,
                            fs, chunk_ms, nmax, torch.device("cpu"))
    cap = driver.segment_capacity(fs, chunk_ms, nmax)
    pos, n_was, used = [0] * len(lens), [0] * len(lens), [0] * len(lens)
    buffers, carried, n_chunks = set(), 0, 0
    try:
        while chunks.refill():
            n_chunks += 1
            assert n_chunks < 40
            want = [min(500 + nmax, L - p) for L, p in zip(lens, pos)]
            assert chunks.n == want
            new = [n - max(w - u, 0) for n, w, u in zip(want, n_was, used)]
            carried += sum(n - k for n, k in zip(want, new))
            nbytes = chunks.upload()
            assert nbytes == sum(new) * (1 if int4 else 2)
            x = chunks.x
            assert x.shape[0] == len(lens) * cap
            buffers.add(x.data_ptr())
            host = torch.cat([_host_segment(r, p, n, cap, int4)
                              for r, p, n in zip(raws, pos, want)])
            assert torch.equal(torch.view_as_real(x), torch.view_as_real(host))
            # each channel moves on to within the band's samples
            ptr = np.array([b * cap + int(rng.integers(-(-want[b] // 2),
                                                       want[b] + 1))
                            for b in band_of], np.int32)
            state, used = chunks.rebase(_Ptr(torch.from_numpy(ptr.copy())))
            for b in range(len(lens)):
                least = min(int(ptr[k]) for k in range(len(ptr))
                            if band_of[k] == b)
                assert used[b] == least - b * cap
            np.testing.assert_array_equal(
                state.ptr.numpy(), ptr - np.array(used)[band_of])
            n_was = want
            pos = [p + u for p, u in zip(pos, used)]
        assert pos == list(lens) and chunks.done
    finally:
        chunks.close()
    assert n_chunks >= 5 and carried > 0 and len(buffers) == 2
