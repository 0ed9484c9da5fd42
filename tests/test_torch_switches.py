"""The reference's environment switches, honoured by every entry point as
the reference reads them (set means non-empty), each case held against
the JAX package under the same switch, on the CPU:

  GNSS_DSP_NO_PALLAS    acquisition takes the XLA engine: the circular
                        search at the data window (acquire/plan route
                        "xla"), the coherent search its XLA engine, and
                        tracking the plain scan (the reference's
                        acquire/engine.py:307, acquire/coherent.py:356,
                        track/driver.py:112), on the CPU only: given a
                        card, every entry point refuses it
                        (device.refuse_no_pallas), since the port runs
                        nothing but its kernels there
  GNSS_DSP_NO_V2P       the pad2 signals take the circular search at
                        their 2n window (route "v1", K7 on the card;
                        acquire/engine.py:318); tracking and the coherent
                        search do not read it
  GNSS_DSP_UPLOAD_INT4  track_file quantises each chunk to 4 bits
                        (track/driver.py:623-627)
  GNSS_DSP_CPU          the CLIs' default device is the CPU (the
                        reference's cli/acquire.py:64-68, cli/track.py:76
                        and :152-157, cli/squaring.py:22-28), named on
                        stderr; an explicit --device wins (held against
                        the same CLI's --device cpu rows)

The JAX package on a CPU takes its XLA engines whatever the switches say,
so a port search under a switch that routes it to the same circular
search must give the JAX package's cells.
"""

import io

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.acquire.coherent import acquire_signal_coherent
from gnss_dsp_tpu_torch.acquire.engine import (
    acquire_signal, acquire_signal_fdma)
from gnss_dsp_tpu_torch.acquire.plan import acq_plan, coh_plan, mesh_plan
from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.track.driver import (
    TrackChannel, make_params, track_file)
from gnss_dsp_tpu_torch.utils.synth import synth_iq

ALL = ("GNSS_DSP_NO_PALLAS", "GNSS_DSP_NO_V2P", "GNSS_DSP_UPLOAD_INT4")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ALL:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _planted(name, ms, plants, chan_of=lambda prn: 0):
    """ms + 4 ms of `name` at its acq_fs, one unit signal a plant (prn,
    doppler, code phase), no noise; an FDMA plant's carrier carries its
    channel's band offset."""
    sig = get_signal(name)
    fs = sig.acq_fs
    n = int(fs * (ms + 4) / 1000.0)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in plants:
        ch = chan_of(prn)
        x += synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                      doppler_hz=dop + sig.fdma_hz * ch, code_phase=cp,
                      cn0_dbhz=None, carrier_ratio=sig.track_carrier_ratio(ch),
                      code_doppler_hz=dop)
    x += 0.05 * (np.random.default_rng(len(plants)).standard_normal(n)
                 + 1j * np.random.default_rng(9).standard_normal(n)
                 ).astype(np.complex64)
    return sig, x


# (name, ms, prns, plants, grid) of the non-coherent searches held here:
# GPS L1 (circular n) and GPS L5I (pad2: 2n = 61380, no aligned split)
ACQ = {"gps-l1": ("gps-l1", 3, [3, 7], [(3, 1010.0, 100.25)],
                  (-1500.0, 1500.0, 500.0)),
       "gps-l5i": ("gps-l5i", 3, [25, 7], [(25, 1010.0, 5000.25)],
                   (-1000.0, 2000.0, 1000.0))}


def _acquire(name="gps-l5i"):
    name, ms, prns, plants, grid = ACQ[name]
    sig, x = _planted(name, ms, plants)
    return acquire_signal(sig, torch.from_numpy(x), prns, grid, ms=ms)


def _jax_acquire(name="gps-l5i"):
    from gnss_dsp_tpu.acquire.engine import acquire_signal as jacq
    from gnss_dsp_tpu.models import get_signal as jsig

    name, ms, prns, plants, grid = ACQ[name]
    _, x = _planted(name, ms, plants)
    return jacq(jsig(name), x, prns, doppler_search=grid, ms=ms)


FDMA = ([-1, 0, 2], [(2, 505.0, 200.5)], (-1000.0, 1000.0, 500.0), 2)


def _acquire_fdma():
    chans, plants, grid, ms = FDMA
    sig, x = _planted("glonass-l1", ms, plants, chan_of=lambda c: c)
    return acquire_signal_fdma(sig, torch.from_numpy(x), chans, grid, ms=ms)


def _jax_acquire_fdma():
    from gnss_dsp_tpu.acquire.engine import acquire_signal_fdma as jfdma
    from gnss_dsp_tpu.models import get_signal as jsig

    chans, plants, grid, ms = FDMA
    _, x = _planted("glonass-l1", ms, plants, chan_of=lambda c: c)
    return jfdma(jsig("glonass-l1"), x, chans, doppler_search=grid, ms=ms)


COH = ([1, 3], [(3, 255.0, 300.5)], (-250.0, 500.0, 250.0), 2, 4)


def _acquire_coherent():
    prns, plants, grid, m, ms = COH
    sig, x = _planted("gps-l1", ms, plants)
    return acquire_signal_coherent(sig, torch.from_numpy(x), prns, grid,
                                   m_coh=m, ms=ms)


def _jax_acquire_coherent():
    from gnss_dsp_tpu.acquire.coherent import acquire_signal_coherent as jcoh
    from gnss_dsp_tpu.models import get_signal as jsig

    prns, plants, grid, m, ms = COH
    _, x = _planted("gps-l1", ms, plants)
    return jcoh(jsig("gps-l1"), x, prns, grid, m_coh=m, ms=ms)


def _capture():
    from gnss_dsp_tpu_torch.utils import synth

    sig = get_signal("gps-l1")
    x = synth.synth_iq(sig.code_table((3,))[0], sig.chip_rate, 4.096e6,
                       40_000, doppler_hz=1000.0, code_phase=10.0,
                       cn0_dbhz=None, carrier_ratio=1540.0)
    return synth.to_int8_iq(x, scale=24.0)


def _track():
    ch = [TrackChannel(prn=3, doppler=1000.0, code_offset=10.0)]
    track_file(get_signal("gps-l1"), io.BytesIO(_capture()), 4.096e6, 0.0,
               ch, max_blocks=6, device="cpu")
    return ch[0].rows


def _jax_track():
    from gnss_dsp_tpu.models import get_signal as jsig
    from gnss_dsp_tpu.track.driver import TrackChannel as JChannel
    from gnss_dsp_tpu.track.driver import track_file as jtrack

    ch = [JChannel(prn=3, doppler=1000.0, code_offset=10.0)]
    jtrack(jsig("gps-l1"), io.BytesIO(_capture()), 4.096e6, 0.0, ch,
           max_blocks=6)
    return ch[0].rows


def same_acquisition(got, want, rtol=1e-5):
    """Winning cells equal (id, doppler, code offset), metric within
    rtol."""
    assert [r.prn for r in got] == [r.prn for r in want]
    for a, b in zip(got, want):
        assert (a.doppler, a.code_offset) == (b.doppler, b.code_offset), \
            (a, b)
        np.testing.assert_allclose(a.metric, b.metric, rtol=rtol)


def same_rows(got, want):
    """The tracking tolerance: integers equal, floats rtol 2e-5 /
    atol 2e-4."""
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert [a[k] for k in ("block", "samp", "code_cyc")] == \
            [b[k] for k in ("block", "samp", "code_cyc")]
        for k in ("p_re", "p_im", "carrier_f", "prompt", "code_p"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-4)


ENTRIES = {"acquire_signal": (_acquire, _jax_acquire, same_acquisition),
           "acquire_signal_fdma": (_acquire_fdma, _jax_acquire_fdma,
                                   same_acquisition),
           "acquire_signal_coherent": (_acquire_coherent,
                                       _jax_acquire_coherent,
                                       same_acquisition),
           "track_file": (_track, _jax_track, same_rows)}
CASES = [("acquire_signal", "GNSS_DSP_NO_PALLAS"),
         ("acquire_signal", "GNSS_DSP_NO_V2P"),
         ("acquire_signal_fdma", "GNSS_DSP_NO_PALLAS"),
         ("acquire_signal_coherent", "GNSS_DSP_NO_PALLAS"),
         ("acquire_signal_coherent", "GNSS_DSP_NO_V2P"),
         ("track_file", "GNSS_DSP_NO_PALLAS"),
         ("track_file", "GNSS_DSP_NO_V2P"),
         ("track_file", "GNSS_DSP_UPLOAD_INT4")]
# the cases whose result the switch leaves as it was unset
UNMOVED = {("acquire_signal_coherent", "GNSS_DSP_NO_V2P"),
           ("track_file", "GNSS_DSP_NO_V2P"),
           ("track_file", "GNSS_DSP_NO_PALLAS")}


@pytest.mark.parametrize("entry,switch", CASES)
def test_entry_point_refuses_a_set_switch(clean_env, entry, switch):
    """Every entry point runs under each switch it could read (none
    refuses any more) and gives the JAX package's result under the same
    switch: acquisitions the same winning cells with the metric within
    rtol 1e-5 (the same circular search), tracks the tracking tolerance.
    A switch the reference does not route this entry point by, and
    NO_PALLAS on a CPU run of track_file (already the plain scan), leave
    the result exactly as unset; the int4 front end changes the rows."""
    port, jax_fn, same = ENTRIES[entry]
    unset = port()
    clean_env.setenv(switch, "1")
    got = port()
    if (entry, switch) in UNMOVED:
        assert got == unset
    if entry == "acquire_signal_coherent" and switch == "GNSS_DSP_NO_V2P":
        return        # the JAX package's CPU run is its XLA engine
    same(got, jax_fn())
    if switch == "GNSS_DSP_UPLOAD_INT4":
        assert [r["p_re"] for r in got] != [r["p_re"] for r in unset]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_point_runs_with_the_switches_empty(clean_env, entry):
    """An empty value is unset (os.environ.get is falsy): with every
    switch empty each entry point gives exactly its unset result.  An
    entry point does not read a switch outside its list: each
    acquisition gives exactly its unset result with GNSS_DSP_UPLOAD_INT4
    set."""
    unset = ENTRIES[entry][0]()
    for name in ALL:
        clean_env.setenv(name, "")
    assert ENTRIES[entry][0]() == unset
    if entry != "track_file":
        clean_env.setenv("GNSS_DSP_UPLOAD_INT4", "1")
        assert ENTRIES[entry][0]() == unset


def test_no_pallas_gps_l1_acquire_matches_jax(clean_env):
    """GPS L1 (circular n = 4096) under NO_PALLAS: the xla route, the JAX
    package's cells, metric rtol 1e-5."""
    clean_env.setenv("GNSS_DSP_NO_PALLAS", "1")
    assert acq_plan(get_signal("gps-l1"))[0] == "xla"
    same_acquisition(_acquire("gps-l1"), _jax_acquire("gps-l1"))


def test_no_v2p_gps_l5i_takes_the_circular_2n_search(clean_env):
    """Under NO_V2P GPS L5I searches all 2n = 61380 circular lags (v1);
    unset it searches the padded 65536 window masked to n lags (v2p),
    whose planted cell is the same."""
    sig = get_signal("gps-l5i")
    v2p = acq_plan(sig)
    clean_env.setenv("GNSS_DSP_NO_V2P", "1")
    assert v2p == ("v2p", 65536, 61380, 30690)
    assert acq_plan(sig) == ("v1", 61380, 61380, 0)
    got = _acquire("gps-l5i")
    clean_env.delenv("GNSS_DSP_NO_V2P")
    padded = _acquire("gps-l5i")
    assert (got[0].doppler, got[0].code_offset) == \
        (padded[0].doppler, padded[0].code_offset)


@pytest.mark.parametrize("name", ["gps-l1", "gps-l5i", "xona-x5d",
                                  "galileo-e1b", "gps-l2cm", "glonass-l1"])
def test_routes_under_the_switches(clean_env, name):
    """The routes each switch gives, and with none set the routes as
    before (v2, v2p or v1 by the window; K2 for tracking)."""
    sig = get_signal(name)
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    dw = 2 * n if (sig.acq_pad2 or sig.acq_sliding) else n
    route, window, data_window, _ = acq_plan(sig)
    assert route in ("v2", "v2p", "v1") and data_window == dw
    assert mesh_plan(sig)[0] in ("v2", "v1")
    p = make_params(sig, sig.acq_fs, 0.0)
    assert p.fused_scan and p.pallas_v2

    clean_env.setenv("GNSS_DSP_NO_V2P", "1")
    assert acq_plan(sig) == ((route, window, dw, 0) if route != "v2p"
                             else ("v1", dw, dw, 0))
    assert make_params(sig, sig.acq_fs, 0.0) == p
    clean_env.delenv("GNSS_DSP_NO_V2P")

    clean_env.setenv("GNSS_DSP_NO_PALLAS", "1")
    assert acq_plan(sig) == ("xla", dw, dw, 0)
    assert mesh_plan(sig) == ("xla", dw)
    assert coh_plan(sig, n, 2, 1) is None
    q = make_params(sig, sig.acq_fs, 0.0)
    assert not (q.fused_scan or q.pallas_v2)
    assert q._replace(fused_scan=True, pallas_v2=True) == p


def test_no_pallas_sharded_search_matches_the_single_search(clean_env):
    """The sharded twin under NO_PALLAS (each shard's surface in plain
    torch) gives the single search's cells on a 2 x 2 mesh of CPU
    shards, metric rtol 1e-5."""
    from gnss_dsp_tpu_torch.parallel.acquire import acquire_signal_sharded
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    clean_env.setenv("GNSS_DSP_NO_PALLAS", "1")
    name, ms, prns, plants, grid = ACQ["gps-l1"]
    sig, x = _planted(name, ms, plants)
    mesh = make_mesh(4, time_shards=2, devices=[torch.device("cpu")] * 4)
    got = acquire_signal_sharded(sig, torch.from_numpy(x), prns, mesh,
                                 doppler_search=grid, ms=ms)
    same_acquisition(got, _acquire("gps-l1"))


def test_no_pallas_keeps_the_reference_mesh_refusals(clean_env):
    """Under NO_PALLAS the reference's mesh needs its fused kernel for a
    mixed-signal run and for coherent tracking (driver.py:280-283,
    318-324): the port refuses both as it does, and the single-signal
    mesh runs the plain scan a shard."""
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    clean_env.setenv("GNSS_DSP_NO_PALLAS", "1")
    mesh = make_mesh(2, time_shards=1, devices=[torch.device("cpu")] * 2)
    sig, l1c = get_signal("gps-l1"), get_signal("gps-l1cp")

    def chans():
        return [TrackChannel(prn=3, doppler=1000.0, code_offset=10.0),
                TrackChannel(prn=5, doppler=0.0, code_offset=0.0)]

    with pytest.raises(ValueError, match="NO_PALLAS"):
        track_file(sig, io.BytesIO(_capture()), 4.096e6, 0.0, chans(),
                   max_blocks=4, device="cpu", mesh=mesh, sigs=[sig, l1c])
    with pytest.raises(ValueError, match="NO_PALLAS"):
        track_file(get_signal("beidou-b1i"), io.BytesIO(_capture()),
                   4.096e6, 0.0, chans(), max_blocks=4, device="cpu",
                   mesh=mesh, coherent_blocks=20)
    ch = chans()
    track_file(sig, io.BytesIO(_capture()), 4.096e6, 0.0, ch, max_blocks=6,
               device="cpu", mesh=mesh)
    assert ch[0].rows == _track()


def _card_calls():
    """(name, call) of every entry point the switch reaches, each given a
    device that is not the CPU: a "meta" tensor for the acquisitions
    (nothing is computed before the refusal), device="cuda" for the
    tracks (refused before the device is resolved)."""
    from gnss_dsp_tpu_torch.parallel.acquire import (
        acquire_signal_fdma_sharded, acquire_signal_sharded)
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh
    from gnss_dsp_tpu_torch.track.receiver import track_receiver

    x = torch.empty(4096 * 8, dtype=torch.complex64, device="meta")
    l1, glo = get_signal("gps-l1"), get_signal("glonass-l1")
    grid = (-500.0, 500.0, 500.0)
    mesh = make_mesh(1, devices=[torch.device("cpu")])

    def ch():
        return [TrackChannel(prn=3, doppler=1000.0, code_offset=10.0)]

    return [
        ("acquire_signal", lambda: acquire_signal(l1, x, [1], grid, ms=3)),
        ("acquire_signal_fdma",
         lambda: acquire_signal_fdma(glo, x, [0], grid, ms=2)),
        ("acquire_signal_coherent",
         lambda: acquire_signal_coherent(l1, x, [1], grid, m_coh=2, ms=4)),
        ("acquire_signal_sharded",
         lambda: acquire_signal_sharded(l1, x, [1], mesh, grid, ms=3)),
        ("acquire_signal_fdma_sharded",
         lambda: acquire_signal_fdma_sharded(glo, x, [0], mesh, grid,
                                             ms=2)),
        ("track_file",
         lambda: track_file(l1, io.BytesIO(_capture()), 4.096e6, 0.0, ch(),
                            max_blocks=2, device="cuda")),
        ("track_receiver",
         lambda: track_receiver([(io.BytesIO(_capture()), [l1], ch(),
                                  [0.0])], 4.096e6, max_blocks=2,
                                device="cuda")),
    ]


@pytest.mark.parametrize("k", range(7))
def test_no_pallas_is_refused_on_a_card(clean_env, k):
    """GNSS_DSP_NO_PALLAS with a card: every entry point raises, naming
    the switch, before any work; the port never runs a plain version on
    the card.  The same call with the switch unset passes the check
    (it then fails further on, for want of a card or of data)."""
    name, call = _card_calls()[k]
    try:
        call()
    except RuntimeError as e:
        assert "GNSS_DSP_NO_PALLAS" not in str(e), name
    except Exception:
        pass
    clean_env.setenv("GNSS_DSP_NO_PALLAS", "1")
    with pytest.raises(RuntimeError, match=f"{name}: GNSS_DSP_NO_PALLAS"):
        call()


def test_no_pallas_is_refused_on_a_mesh_with_a_card(clean_env):
    """A CPU tensor sharded over a mesh that holds a card refuses the
    switch too, as does track_file under such a mesh."""
    from gnss_dsp_tpu_torch.parallel.acquire import acquire_signal_sharded
    from gnss_dsp_tpu_torch.parallel.mesh import Mesh

    clean_env.setenv("GNSS_DSP_NO_PALLAS", "1")
    mesh = Mesh([[torch.device("cpu"), torch.device("cuda")]], [[0, 0]])
    x = torch.zeros(4096 * 8, dtype=torch.complex64)
    with pytest.raises(RuntimeError, match="GNSS_DSP_NO_PALLAS"):
        acquire_signal_sharded(get_signal("gps-l1"), x, [1], mesh,
                               (-500.0, 500.0, 500.0), ms=3)
    with pytest.raises(RuntimeError, match="GNSS_DSP_NO_PALLAS"):
        track_file(get_signal("gps-l1"), io.BytesIO(_capture()), 4.096e6,
                   0.0, [TrackChannel(prn=3, doppler=0.0, code_offset=0.0)],
                   max_blocks=2, device="cpu", mesh=mesh)


# ---------------------------------------------------------- GNSS_DSP_CPU

def _run_cli(main, args, out_path=None):
    """(stdout, stderr) of main(*args); with out_path the CLI's binary
    stdout goes to that file and stdout is its bytes."""
    import contextlib
    import types

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if out_path is None:
            rc = main(*args)
        else:
            import sys

            with open(out_path, "wb") as f:
                saved = sys.stdout
                sys.stdout = types.SimpleNamespace(buffer=f)
                try:
                    rc = main(*args)
                finally:
                    sys.stdout = saved
            with open(out_path, "rb") as f:
                out = io.BytesIO(f.read())
    assert rc in (0, None)
    return out.getvalue(), err.getvalue()


def _file(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _fdma_capture():
    sig = get_signal("glonass-l1")
    fs = sig.acq_fs
    x = synth_iq(sig.code_table((0,))[0], sig.chip_rate, fs, int(fs * 0.008),
                 doppler_hz=300.0 + sig.fdma_hz, code_phase=100.0,
                 cn0_dbhz=None, carrier_ratio=sig.track_carrier_ratio(1),
                 code_doppler_hz=300.0)
    from gnss_dsp_tpu_torch.utils.synth import to_int8_iq

    return to_int8_iq(x, scale=24.0), fs


def _cpu_cli(case, tmp_path):
    """(main, argv without --device, binary) of one CLI call on a small
    capture."""
    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import squaring as sq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli

    l1 = _file(tmp_path, "l1.iq", _capture())
    acq = ["--prn", "3,7", "--doppler-search", "-1500,1500,500"]
    if case == "acquire":
        return acq_cli.main, ("gps-l1", acq + ["--time", "3", l1, "4096000",
                                               "0"]), False
    if case == "acquire --coherent":
        return acq_cli.main, ("gps-l1", acq + ["--time", "4", "--coherent",
                                               "2", l1, "4096000", "0"]), False
    if case == "acquire fdma":
        data, fs = _fdma_capture()
        return acq_cli.main, ("glonass-l1", [
            "--channel", "0,1", "--doppler-search", "-500,501,250", "--time",
            "2", _file(tmp_path, "glo.iq", data), str(fs), "0"]), False
    if case == "track":
        return trk_cli.main, ("gps-l1", ["--blocks", "6", l1, "4096000", "0",
                                         "3", "1000.0", "10.0"]), False
    if case == "track multi":
        return trk_cli.main, ("multi", ["--blocks", "6", l1, "4096000", "0",
                                        "gps-l1:3:1000.0:10.0"]), False
    assert case == "squaring"
    n = sq_cli.B * sq_cli.N * sq_cli.M + 100
    raw = np.random.default_rng(3).integers(-20, 21, 2 * n).astype(np.int8)
    return sq_cli.main, ([_file(tmp_path, "sq.iq", raw.tobytes()),
                          "4000000", "2500"],), True


def _with_device(args, device):
    return args[:-1] + (list(args[-1]) + ["--device", device],)


@pytest.fixture
def cpu_env(monkeypatch):
    for name in ALL + ("GNSS_DSP_CPU", "GNSS_DSP_TIMING"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


CPU_CASES = ("acquire", "acquire --coherent", "acquire fdma", "track",
             "track multi", "squaring")


@pytest.mark.parametrize("case", CPU_CASES)
def test_gnss_dsp_cpu_pins_the_cli_to_the_cpu(cpu_env, tmp_path, case):
    """GNSS_DSP_CPU set (the reference pins its CLIs to the CPU with it):
    with no card (torch.cuda.is_available False) each CLI runs on the
    CPU without --device, prints its --device cpu rows byte for byte and
    one stderr line naming the switch; an explicit --device wins over the
    switch: --device cpu prints no such line, --device cuda still asks
    for the card, which raises."""
    main, args, binary = _cpu_cli(case, tmp_path)
    out = str(tmp_path / "out.bin") if binary else None
    want, err = _run_cli(main, _with_device(args, "cpu"), out)
    assert want and "GNSS_DSP_CPU" not in err
    cpu_env.setattr(torch.cuda, "is_available", lambda: False)
    cpu_env.setenv("GNSS_DSP_CPU", "1")
    got, err = _run_cli(main, args, out)
    assert got == want
    named = [line for line in err.splitlines() if "GNSS_DSP_CPU" in line]
    assert len(named) == 1 and "CPU" in named[0].split("GNSS_DSP_CPU")[1]
    got, err = _run_cli(main, _with_device(args, "cpu"), out)
    assert got == want and "GNSS_DSP_CPU" not in err
    with pytest.raises(RuntimeError, match="is_available"):
        _run_cli(main, _with_device(args, "cuda"), out)


def test_gnss_dsp_cpu_pins_the_workload(cpu_env, tmp_path):
    """cli.workload acquire-all under GNSS_DSP_CPU and no card: every
    script gets --device cpu (the mains replaced by recorders, as in
    tests/test_torch_workload.py), its files those of --device cpu, and
    the runner names the switch once; --device cuda with the switch set
    still reaches the card's check in the first acquisition."""
    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import workload

    cap = _file(tmp_path, "c.pcap", np.zeros(3 * 3 * 2 * 69984, np.int8)
                .tobytes())
    real = acq_cli.main

    def acq(signal, argv, x_cache=None):
        print(f"{signal} {' '.join(argv[1:])}")
        return 0

    def files(dest):
        return {row[3]: (tmp_path / dest / row[3]).read_text()
                for row in workload.ACQUIRE_ALL}

    cpu_env.setattr(acq_cli, "main", acq)
    _run_cli(workload.main, (["acquire-all", cap, str(tmp_path / "a"),
                              "--device", "cpu"],))
    want = files("a")
    assert all(v.endswith("--device cpu\n") for v in want.values())
    cpu_env.setattr(torch.cuda, "is_available", lambda: False)
    cpu_env.setenv("GNSS_DSP_CPU", "1")
    _, err = _run_cli(workload.main, (["acquire-all", cap,
                                       str(tmp_path / "b")],))
    assert files("b") == want
    assert sum("GNSS_DSP_CPU" in line for line in err.splitlines()) == 1
    cpu_env.setattr(acq_cli, "main", real)
    with pytest.raises(RuntimeError, match="is_available"):
        workload.main(["acquire-all", cap, str(tmp_path / "c"), "--device",
                       "cuda"])


def test_gnss_dsp_cpu_moves_the_shell_workloads(cpu_env, tmp_path):
    """The shell workloads pass DEVICE to every script: unset, cuda; with
    GNSS_DSP_CPU set and no DEVICE given, cpu, named once on stderr; a
    DEVICE given wins.  (The demuxer and the scripts are replaced by
    stubs that print their argv.)"""
    import os
    import shutil
    import subprocess

    from gnss_dsp_tpu_torch.tools.gen_compat_scripts import acquire_all_sh

    d = tmp_path / "s"
    (d / "scripts").mkdir(parents=True)
    (d / "tools").mkdir()
    (d / "tools" / "packet2wav_3ch.py").write_text("")
    (d / "scripts" / "acquire-all.sh").write_text(acquire_all_sh())
    for line in acquire_all_sh().splitlines():
        if '"$S"/' in line:
            name = line.split('"$S"/')[1].split()[0]
            (d / "scripts" / name).write_text(
                "import sys\nprint(' '.join(sys.argv[1:]))\n")
    data = _file(tmp_path, "data", b"")

    def run(*extra, cpu=None):
        env = {k: v for k, v in os.environ.items() if k != "GNSS_DSP_CPU"}
        if cpu:
            env["GNSS_DSP_CPU"] = cpu
        dest = tmp_path / f"o{len(list(tmp_path.iterdir()))}"
        r = subprocess.run(["sh", str(d / "scripts" / "acquire-all.sh"),
                            data, str(dest), *extra], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        outs = {p.read_text().split()[-1] for p in dest.iterdir()}
        return outs, r.stderr

    assert shutil.which("sh")
    assert run() == ({"cuda"}, "")
    outs, err = run(cpu="1")
    assert outs == {"cpu"} and err.count("GNSS_DSP_CPU") == 1
    assert run("cuda", cpu="1") == ({"cuda"}, "")
