"""A scan's rows as the track CLI's text in bulk (track/rows.RowText,
ops/track_rows) on the CPU, held to the row-by-row path:

  * RowText's bulk path, with a row-by-row stand-in for the kernel
    (rows_text_by_row: its head and text made with format_row_14/9),
    writes `prefix + format_row_14/9(row) + "\\n"` of every row emit_rows
    emits with a plain callable, on seed-drawn float32 rows with %f ties
    (odd x 2^-7), -0.0, negatives below 5e-7, NaN of both signs, +-inf
    and the largest float32 below the fixed-point bound; with n == 0
    rows, clones past n_emit, nb below the rows' length, samp past 2^31,
    9- and 14-column channels;
  * the channels' three counters and emit_rows's value equal the
    row-by-row path's, the counters track.rows.bulk / .each count the
    rows each way;
  * a scan with a field past the bound (or a counter past 2^62) takes
    the row-by-row path, counted as track.rows.each;
  * off the card a RowText writes a row at a time, and rows_text refuses
    CPU tensors;
  * the track CLI (main and `multi`) prints byte for byte what
    track_file prints with a plain per-row emit of the same prefixes.

The card's kernel is held to rows_text_by_row and the row-by-row text in
tests/test_torch_cuda.py (-k rows_text).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.cli import track as trk_cli
from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.ops import track_rows
from gnss_dsp_tpu_torch.track import driver
from gnss_dsp_tpu_torch.track.rows import RowText, format_row_9, format_row_14
from gnss_dsp_tpu_torch.utils import profiling
from gnss_dsp_tpu_torch.utils.synth import synth_iq, to_int8_iq


def _below_bound():
    """The largest float32 below the fixed-point bound."""
    f = np.float32(track_rows.FIXED_MAX)
    while float(f) >= track_rows.FIXED_MAX:
        f = np.nextafter(f, np.float32(0))
    return f


SPECIAL = np.array([0.0078125, -0.0078125, 3 * 2.0 ** -7, 0.5e-6, 1.5e-6,
                    2.5e-6, -0.0, 0.0, -4.9e-7, -1e-9, np.nan,
                    np.copysign(np.nan, -1.0), np.inf, -np.inf,
                    _below_bound(), -_below_bound(), 123456.789, -1.0,
                    1e-45], np.float32)


def scan_rows(seed, B, C, zero_share=0.2):
    """Seed-drawn rows_f f32 [B, C, 11], rows_i i32 [B, C, 3] as
    track_scan returns them, SPECIAL values planted among the floats."""
    rng = np.random.default_rng(seed)
    rf = (rng.standard_normal((B, C, 11))
          * 10.0 ** rng.integers(-7, 8, (B, C, 11))).astype(np.float32)
    odd = rng.integers(0, 2 ** 20, (B, C, 11)) * 2 + 1
    ties = (odd * 2.0 ** -7).astype(np.float32)
    pick = rng.random((B, C, 11))
    rf = np.where(pick < 0.15, ties, rf)
    rf = np.where(pick > 0.85, rng.choice(SPECIAL, (B, C, 11)), rf)
    rf[..., 0] = (np.arange(B)[:, None] + rng.choice(
        [0.0, 0.25, -0.75, 1e6], (B, C))).astype(np.float32)
    ri = np.stack([rng.integers(1, 300_000, (B, C)),
                   rng.integers(-2 ** 31, 2 ** 31, (B, C)),
                   rng.integers(0, 2 ** 31, (B, C))], -1).astype(np.int32)
    ri[..., 0] *= rng.random((B, C)) >= zero_share
    return torch.from_numpy(rf), torch.from_numpy(ri)


def _channels(C, seed):
    rng = np.random.default_rng(seed + 1)
    return [driver.TrackChannel(
        prn=k + 1, doppler=0.0, code_offset=0.0,
        samp=int(rng.integers(2 ** 31, 2 ** 35)),
        code_cyc=int(rng.integers(0, 2 ** 40)),
        carrier_cyc=int(rng.integers(-2 ** 40, 2 ** 40))) for k in range(C)]


def _counters(channels):
    return [(c.samp, c.code_cyc, c.carrier_cyc) for c in channels]


def _per_row(prefixes, formats):
    """A plain per-row emit writing what the CLI printed a row at a
    time, and the text it wrote."""
    out = []

    def emit(k, row):
        fmt = format_row_14 if formats[k] == 14 else format_row_9
        out.append(prefixes[k] + fmt(row) + "\n")
    return emit, out


def rows_text_by_row(rows_f, rows_i, nb, n_emit, prefix, prefix_off, wide,
                     counters):
    """ops/track_rows.rows_text's head and text made a row at a time with
    format_row_14/9, on any device: what the kernel must give.  A written
    row with a finite used field of |x| >= FIXED_MAX, or a block not
    finite or past it, flags the scan (no text, no lines)."""
    rf = rows_f[:nb].cpu().numpy()
    ri = rows_i[:nb].cpu().numpy()
    pre, off = bytes(prefix.cpu().numpy()), prefix_off.tolist()
    wide, run = wide.tolist(), counters.tolist()
    lines, flagged = [], False
    for b in range(nb):
        for k in range(n_emit):
            n = int(ri[b, k, 0])
            if n == 0:
                continue
            c = run[k]
            c[0] += n
            c[1] += int(ri[b, k, 2])
            c[2] += int(ri[b, k, 1])
            f = rf[b, k].astype(np.float64)
            used = f[1:11] if wide[k] else f[1:9]
            if not (np.isfinite(f[0]) and abs(f[0]) < track_rows.FIXED_MAX) \
                    or (np.abs(used[np.isfinite(used)])
                        >= track_rows.FIXED_MAX).any():
                flagged = True
                continue
            row = dict(block=int(f[0]), p_re=f[1], p_im=f[2],
                       carrier_f=f[3], code_f_offset=f[4], phase_deg=f[5],
                       early=f[6], prompt=f[7], late=f[8], code_cyc=c[1],
                       code_p=f[9], carrier_cyc=c[2], carrier_p=f[10],
                       samp=c[0])
            fmt = format_row_14 if wide[k] else format_row_9
            lines.append(pre[off[k]:off[k + 1]] + (fmt(row) + "\n").encode())
    text = b"" if flagged else b"".join(lines)
    head = [len(text), 0 if flagged else len(lines),
            int((ri[..., 0] != 0).any()), int(flagged)]
    return (torch.tensor(head + [v for c in run for v in c],
                         dtype=torch.int64),
            torch.tensor(list(text), dtype=torch.uint8))


@pytest.fixture
def bulk_row_text(monkeypatch):
    """Makes RowTexts that take the bulk path on the CPU, the kernel's
    call replaced by rows_text_by_row."""
    monkeypatch.setattr(track_rows, "rows_text", rows_text_by_row)

    def make(prefixes, formats):
        rt = RowText(prefixes, formats, "cpu")
        rt.bulk = True
        return rt
    return make


def row_by_row(rf, ri, nb, n_emit, prefixes, formats, seed):
    """(text, channels, value) of emit_rows with a plain per-row emit."""
    ref_ch = _channels(rf.shape[1], seed)
    emit, out = _per_row(prefixes, formats)
    want = driver.emit_rows(ref_ch, n_emit, emit, rf, ri, nb)
    return "".join(out), ref_ch, want


def _both(rf, ri, nb, n_emit, prefixes, formats, seed, make):
    """row_by_row's (text, channels, value), and (text, channels, value,
    counts) of emit_rows with the RowText make(prefixes, formats)."""
    got_ch = _channels(rf.shape[1], seed)
    buf = io.StringIO()
    with profiling.Timing(keep=True) as timed, \
            contextlib.redirect_stdout(buf):
        got = driver.emit_rows(got_ch, n_emit, make(prefixes, formats), rf,
                               ri, nb)
    return (row_by_row(rf, ri, nb, n_emit, prefixes, formats, seed),
            (buf.getvalue(), got_ch, got, timed.counts))


CASES = {
    "one-channel": (11, 40, 40, 1, 1, [""], [14]),
    "channels": (12, 30, 30, 5, 5, [f"ch{k} " for k in range(5)], [14] * 5),
    "multi-9-and-14": (13, 25, 25, 4, 4,
                       ["gps-l1:3 ", "galileo-e1b:11 ", "gps-l1:9 ",
                        "beidou-b1i:7 "], [14, 9, 14, 9]),
    "clones-and-short-nb": (14, 33, 20, 6, 4,
                            [f"ch{k} " for k in range(4)], [14] * 4),
    "all-idle": (15, 8, 8, 3, 3, ["a ", "b ", "c "], [14, 9, 14]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bulk_text_equals_row_by_row(case, bulk_row_text):
    seed, B, nb, C, n_emit, prefixes, formats = CASES[case]
    rf, ri = scan_rows(seed, B, C,
                       zero_share=1.0 if case == "all-idle" else 0.2)
    if case == "multi-9-and-14":
        rf[:, 1, 9:] = 1e30          # 9 columns: code_p, carrier_p unused
    (want, ref_ch, ref_any), (got, got_ch, got_any, counts) = _both(
        rf, ri, nb, n_emit, prefixes, formats, seed, bulk_row_text)
    assert got == want
    assert got_any == ref_any
    assert _counters(got_ch) == _counters(ref_ch)
    assert counts == {"track.rows.bulk": want.count("\n")}
    if case == "all-idle":
        assert want == "" and not ref_any
    else:
        assert want.count("\n") > nb // 2 and "nan" in want
        assert max(c[0] for c in _counters(ref_ch)) > 2 ** 31


def test_clones_alone_running_count_as_a_row(bulk_row_text):
    """Rows of the clones are never written, but a clone that ran makes
    emit_rows's value True, on both paths."""
    rf, ri = scan_rows(21, 6, 3)
    ri[:, :2, 0] = 0
    ri[2, 2, 0] = 5
    (want, ref_ch, ref_any), (got, got_ch, got_any, _c) = _both(
        rf, ri, 6, 2, ["x ", "y "], [14, 14], 21, bulk_row_text)
    assert want == got == "" and ref_any and got_any
    assert _counters(got_ch) == _counters(ref_ch)


@pytest.mark.parametrize("what", ["field", "block", "nan-block", "counter"])
def test_out_of_range_scan_goes_row_by_row(what, bulk_row_text):
    """A field at the bound (float32 9.2e12 rounds above it), a block
    past it or not finite, or a counter past 2^62: the scan is written a
    row at a time (track.rows.each), the same text and counters."""
    rf, ri = scan_rows(31, 10, 2)
    ri[..., 0] = 7
    if what == "field":
        rf[4, 1, 3] = -float(np.float32(track_rows.FIXED_MAX))
    elif what == "block":
        rf[2, 0, 0] = 1e13
    elif what == "nan-block":
        rf[2, 0, 0] = np.nan
    prefixes, formats = ["ch1 ", "ch2 "], [14, 14]
    ref_ch, got_ch = _channels(2, 31), _channels(2, 31)
    if what == "counter":
        ref_ch[1].samp = got_ch[1].samp = 2 ** 62
    emit, out = _per_row(prefixes, formats)
    buf = io.StringIO()
    if what == "nan-block":          # int(nan) raises on both paths
        with pytest.raises(ValueError):
            driver.emit_rows(ref_ch, 2, emit, rf, ri, 10)
        with pytest.raises(ValueError), contextlib.redirect_stdout(buf):
            driver.emit_rows(got_ch, 2, bulk_row_text(prefixes, formats),
                             rf, ri, 10)
        return
    want = driver.emit_rows(ref_ch, 2, emit, rf, ri, 10)
    with profiling.Timing(keep=True) as timed, \
            contextlib.redirect_stdout(buf):
        got = driver.emit_rows(got_ch, 2, bulk_row_text(prefixes, formats),
                               rf, ri, 10)
    assert buf.getvalue() == "".join(out) and got == want
    assert _counters(got_ch) == _counters(ref_ch)
    assert timed.counts == {"track.rows.each": 20}


def test_rows_text_refuses_cpu_tensors():
    rf, ri = scan_rows(41, 4, 2)
    n0 = track_rows.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        track_rows.rows_text(rf, ri, 4, 2, torch.zeros(0, dtype=torch.uint8),
                             torch.zeros(3, dtype=torch.int32),
                             torch.ones(2, dtype=torch.int32),
                             torch.zeros((2, 3), dtype=torch.int64))
    assert track_rows.LAUNCHES == n0


def test_row_text_off_the_card_writes_row_by_row():
    """A RowText on the CPU takes no bulk path: the row-by-row text and
    counters, counted as track.rows.each, no launch."""
    seed, B, nb, C, n_emit, prefixes, formats = CASES["multi-9-and-14"]
    rf, ri = scan_rows(seed, B, C)
    n0 = track_rows.LAUNCHES
    (want, ref_ch, ref_any), (got, got_ch, got_any, counts) = _both(
        rf, ri, nb, n_emit, prefixes, formats, seed,
        lambda p, f: RowText(p, f, "cpu"))
    assert got == want and got_any == ref_any
    assert _counters(got_ch) == _counters(ref_ch)
    assert counts == {"track.rows.each": want.count("\n")}
    assert track_rows.LAUNCHES == n0 and want.count("\n") > nb


# --- the track CLI against track_file with a plain per-row emit --------

FS = 4.096e6
TRACK = ["--blocks", "12", "--chunk-ms", "5", "--loop-dwells", "500,500"]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """40 ms at 4.096 MHz: GPS L1 PRNs 3 and 9 and Galileo E1B PRN 11,
    int8 I/Q."""
    n = int(FS * 0.040)
    rng = np.random.default_rng(23)
    x = np.zeros(n, np.complex64)
    for name, prn, dop, cp in (("gps-l1", 3, 1000.0, 211.6),
                               ("gps-l1", 9, -500.0, 803.3),
                               ("galileo-e1b", 11, 700.0, 1500.25)):
        sig = get_signal(name)
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, FS, n,
                      doppler_hz=dop, code_phase=cp, cn0_dbhz=48.0,
                      subcarrier=sig.subcarrier,
                      carrier_ratio=sig.carrier_ratio, rng=rng)
    path = tmp_path_factory.mktemp("rows") / "sky.iq"
    path.write_bytes(to_int8_iq(x, scale=16.0))
    return str(path)


def _cli(main, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(*args) == 0
    return out.getvalue()


CLI = {
    # name: (signal or "multi", channel specs (signal, prn, dop, code))
    "one-channel": ("gps-l1", [("gps-l1", 3, 1000.0, 211.6)]),
    "channels": ("gps-l1", [("gps-l1", 3, 1000.0, 211.6),
                            ("gps-l1", 9, -500.0, 803.3)]),
    "9-columns": ("galileo-e1b", [("galileo-e1b", 11, 700.0, 1500.25)]),
    "multi": ("multi", [("gps-l1", 9, -500.0, 803.3),
                        ("galileo-e1b", 11, 700.0, 1500.25)]),
}


@pytest.mark.parametrize("case", sorted(CLI))
def test_cli_prints_what_track_file_prints_row_by_row(capture, case):
    signal, chans = CLI[case]
    if signal == "multi":
        spec = ",".join(f"{s}:{p}:{d}:{c}" for s, p, d, c in chans)
        prefixes = [f"{s}:{p} " for s, p, _d, _c in chans]
        got = _cli(trk_cli.main_multi,
                   TRACK + [capture, str(FS), "0", spec, "--device", "cpu"])
    else:
        if len(chans) == 1:
            pos = [str(v) for v in chans[0][1:]]
        else:
            pos = [",".join(f"{p}:{d}:{c}" for _s, p, d, c in chans)]
        prefixes = ([f"ch{p} " for _s, p, _d, _c in chans]
                    if len(chans) > 1 else [""])
        got = _cli(trk_cli.main, signal,
                   TRACK + [capture, str(FS), "0"] + pos + ["--device",
                                                          "cpu"])
    sigs = [get_signal(s) for s, *_r in chans]
    emit, out = _per_row(prefixes, [s.row_format for s in sigs])
    with open(capture, "rb") as fp:
        driver.track_file(
            sigs[0], fp, FS, 0.0,
            [driver.TrackChannel(prn=p, doppler=d, code_offset=c)
             for _s, p, d, c in chans],
            loop_dwells=(500, 500), chunk_ms=5.0, max_blocks=12, emit=emit,
            device="cpu", sigs=sigs if signal == "multi" else None)
    want = "".join(out)
    assert got == want
    assert want.count("\n") >= 8 * len(chans)
