"""The single-program multi-band receiver (track/receiver.py) and the
int4 front end (ops/cplx.py), against the JAX package's, the
counterparts of tests/test_receiver.py and tests/test_utils.py:115-157.

Tolerances:
  * the receiver against the JAX receiver (its XLA scan): integer row
    fields equal, floats rtol 2e-3, atol 2e-2, the reference's own
    receiver tolerance (tests/test_receiver.py:82);
  * the receiver against the port's per-band `track multi` runs: equal
    (the plain scan's rows do not depend on where in the chunk a band's
    segment lies);
  * int4 pack and unpack: equal to the JAX package's, bit for bit.
"""

import io

import numpy as np
import pytest
import torch

from gnss_dsp_tpu.models import get_signal as jsig
from gnss_dsp_tpu.ops import cplx as jcplx
from gnss_dsp_tpu.track.driver import TrackChannel as JChannel
from gnss_dsp_tpu.track.driver import track_file as jtrack
from gnss_dsp_tpu.track.receiver import track_receiver as jreceiver
from gnss_dsp_tpu.utils import synth
from gnss_dsp_tpu_torch.models import get_signal as tsig
from gnss_dsp_tpu_torch.ops import cplx
from gnss_dsp_tpu_torch.track import receiver
from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads a worker while this module runs: the test
    workers share the machine's cores, and torch's default of one thread
    a core makes them wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


FS = 4.096e6
INT_KEYS = ("block", "samp", "code_cyc", "carrier_cyc")
FLOAT_KEYS = ("p_re", "p_im", "carrier_f", "code_f_offset", "early",
              "prompt", "late", "code_p")
# band -> [(signal, prn or FDMA channel, doppler, code phase, coffset)]
BANDS = {
    0: [("gps-l1", 7, 900.0, 317.25, 200.0),
        ("glonass-l1", -3, -700.0, 41.5, 200.0)],
    1: [("beidou-b1i", 34, 400.0, 1500.6, -150.0)],
}
# per-channel coherent spans: B1I integrates its NH20, GPS L1 stays at 1
COH_BANDS = {
    0: [("gps-l1", 7, 900.0, 317.25, 200.0)],
    1: [("beidou-b1i", 34, 400.0, 1500.6, -150.0)],
}


def band_stream(rows, seconds, overlays=False):
    n = int(FS * seconds)
    x = np.zeros(n, np.complex64)
    for name, prn, dop, cp, coff in rows:
        sig = jsig(name)
        chan = prn if sig.fdma_hz else 0
        bits = (np.asarray(sig.secondary(prn), np.float64)
                if overlays and sig.secondary is not None else None)
        x += synth.synth_iq(sig.code_table((prn,))[0].astype(np.float64),
                            sig.chip_rate, FS, n,
                            doppler_hz=dop + (sig.fdma_hz or 0.0) * chan
                            + coff, code_phase=cp, cn0_dbhz=None,
                            carrier_ratio=sig.track_carrier_ratio(chan),
                            code_doppler_hz=dop, subcarrier=sig.subcarrier,
                            data_bits=bits)
    return synth.to_int8_iq(x, scale=24.0)


def _bands(bands, data, get, channel):
    out = []
    for b, rows in bands.items():
        out.append((io.BytesIO(data[b]), [get(r[0]) for r in rows],
                    [channel(prn=p, doppler=d, code_offset=cp)
                     for _, p, d, cp, _c in rows], [r[4] for r in rows]))
    return out


def table(rows, keys):
    return np.array([[r[k] for k in keys] for r in rows], np.float64)


@pytest.mark.parametrize("coherent", [1, -1])
def test_receiver_matches_jax_and_per_band_multi(coherent):
    """Both bands in one scan a chunk (chunk_ms 20: three chunks, so the
    per-band rebase runs) against the JAX receiver and against the
    port's per-band mixed-signal track_file."""
    bands = BANDS if coherent == 1 else COH_BANDS
    data = {b: band_stream(rows, 0.05, overlays=coherent != 1)
            for b, rows in bands.items()}
    kw = dict(loop_dwells=(8, 8), max_blocks=48, chunk_ms=20.0,
              coherent_blocks=coherent)
    want = jreceiver(_bands(bands, data, jsig, JChannel), FS, **kw)
    stats = {}
    got = receiver.track_receiver(_bands(bands, data, tsig, TrackChannel),
                                  FS, device="cpu", stats=stats, **kw)
    assert stats["chunks"] >= 3
    k = 0
    for b, rows in bands.items():
        sigs = [tsig(r[0]) for r in rows]
        chans = [TrackChannel(prn=p, doppler=d, code_offset=cp)
                 for _, p, d, cp, _c in rows]
        track_file(sigs[0], io.BytesIO(data[b]), FS, 0.0, chans, sigs=sigs,
                   coffsets=[r[4] for r in rows], device="cpu", **kw)
        for ch in chans:
            a, r = want[k].rows, got[k].rows
            assert len(a) == len(r) == len(ch.rows) >= 40
            np.testing.assert_array_equal(table(r, INT_KEYS),
                                          table(a, INT_KEYS))
            np.testing.assert_allclose(table(r, FLOAT_KEYS),
                                       table(a, FLOAT_KEYS),
                                       rtol=2e-3, atol=2e-2)
            keys = INT_KEYS + FLOAT_KEYS
            np.testing.assert_array_equal(table(r, keys),
                                          table(ch.rows, keys))
            k += 1


def test_int4_pack_unpack_matches_jax():
    """pack_int4_host and from_int4_iq against the JAX package's: the
    packed bytes and the unpacked samples (8 x clip(round(v / 8)))
    equal, the pad zeros."""
    rng = np.random.default_rng(3)
    raw = rng.integers(-128, 128, 8192, dtype=np.int16).astype(np.int8)
    packed = cplx.pack_int4_host(raw)
    np.testing.assert_array_equal(packed, jcplx.pack_int4_host(raw))
    re, im = jcplx.from_int4_iq(jcplx.pack_int4_host(raw), pad=7)
    x = cplx.from_int4_iq(packed, pad=7)
    assert x.dtype.is_complex and x.shape[0] == 4096 + 7
    np.testing.assert_array_equal(x.real.numpy(), np.asarray(re))
    np.testing.assert_array_equal(x.imag.numpy(), np.asarray(im))
    v4 = np.clip((raw.astype(np.int16) + 4) >> 3, -7, 7).astype(np.float32)
    np.testing.assert_array_equal(x.real.numpy()[:4096], 8.0 * v4[0::2])
    assert not x[4096:].abs().any()
    y, nbytes = cplx.from_iq(raw, pad=7, device="cpu", int4=True)
    assert nbytes == 4096 and bool((y == x).all())


def _int4_capture():
    sig = jsig("gps-l1")
    fs, prn, dop, cp = 4.096e6, 7, 1200.0, 300.0
    x = synth.synth_iq(sig.code_table((prn,))[0].astype(np.float64),
                       sig.chip_rate, fs, int(fs * 0.4), doppler_hz=dop,
                       code_phase=cp, cn0_dbhz=45.0, carrier_ratio=1540.0,
                       rng=np.random.default_rng(5))
    sigma = np.sqrt(fs / (2 * 10 ** 4.5))
    return synth.to_int8_iq(x, scale=100.0 / (4 * sigma)), fs, prn, dop, cp


def test_int4_streaming_tracks_as_jax(monkeypatch):
    """GNSS_DSP_UPLOAD_INT4 on track_file: the 4-bit front end still
    locks (within 5 Hz over the last 100 rows, tests/test_utils.py:
    134-157), and the rows match the JAX package's under the same
    switch (integers equal, floats rtol 2e-5 / atol 2e-4 over the
    first 60 blocks, before the 45 dB-Hz noise drives the PLLs apart)."""
    monkeypatch.setenv("GNSS_DSP_UPLOAD_INT4", "1")
    data, fs, prn, dop, cp = _int4_capture()
    ch = TrackChannel(prn=prn, doppler=dop + 30.0, code_offset=cp)
    track_file(tsig("gps-l1"), io.BytesIO(data), fs, 0.0, [ch],
               loop_dwells=(60, 60), chunk_ms=150.0, device="cpu")
    cf = np.median([r["carrier_f"] for r in ch.rows[-100:]])
    assert abs(cf - dop) < 5.0, cf
    jch = JChannel(prn=prn, doppler=dop + 30.0, code_offset=cp)
    jtrack(jsig("gps-l1"), io.BytesIO(data), fs, 0.0, [jch],
           loop_dwells=(60, 60), chunk_ms=150.0, max_blocks=60)
    np.testing.assert_array_equal(table(ch.rows[:60], INT_KEYS),
                                  table(jch.rows, INT_KEYS))
    np.testing.assert_allclose(table(ch.rows[:60], FLOAT_KEYS),
                               table(jch.rows, FLOAT_KEYS),
                               rtol=2e-5, atol=2e-4)


def test_int4_receiver_halves_the_upload(monkeypatch):
    """GNSS_DSP_UPLOAD_INT4 on the receiver: one byte a sample uploaded
    (half of int8's two), and the channel still locks."""
    data, fs, prn, dop, cp = _int4_capture()

    def run(stats):
        bands = [(io.BytesIO(data), [tsig("gps-l1")],
                  [TrackChannel(prn=prn, doppler=dop + 30.0,
                                code_offset=cp)], [0.0])]
        return receiver.track_receiver(bands, fs, loop_dwells=(60, 60),
                                       chunk_ms=150.0, device="cpu",
                                       stats=stats)[0]

    int8, int4 = {}, {}
    run(int8)
    monkeypatch.setenv("GNSS_DSP_UPLOAD_INT4", "1")
    ch = run(int4)
    assert len(int8["upload_bytes"]) == int8["chunks"] >= 3
    assert [2 * b for b in int4["upload_bytes"]] == int8["upload_bytes"]
    cf = np.median([r["carrier_f"] for r in ch.rows[-100:]])
    assert abs(cf - dop) < 5.0, cf
