"""The one-process sky workload and its drop-ins (gnss_dsp_tpu_torch
cli/workload, the CLIs' shared uploads, tools/synth_sky,
tools/packet2wav_3ch, tools/sky_workload, tools/gen_compat_scripts and
scripts/), on the CPU:

  * synth_sky on a 10 ms capture is byte-equal to the root
    tools/synth_sky.py's; packet2wav_3ch.py and demux_bands equal the
    root demuxer and the JAX package's demux_bands;
  * cached reads: cli.acquire.main(x_cache=) prints the uncached rows, a
    file short of n gives "insufficient samples" either way;
  * the preloaded chunk: _preload_chunk and track_file(preloaded=)
    against the JAX package's on a short GPS L1 capture at 4.096 MHz
    (ints equal, floats rtol 2e-5 / atol 2e-4), equal to the port's own
    streaming rows, and the gate's every case falling through to the
    streaming reader; cli.track.main(x_cache=) prints the uncached rows;
  * the runner: cli.workload.main on a small container with the CLI
    mains replaced by recorders (the full 21 + 11 run only on the card,
    chip_smoke.py's e2e_workload): the demux, each main's argv and
    cache, and the files written;
  * sky_workload.validate on planted output files;
  * the drop-ins: the 68 names of the root scripts/, each wrapper the
    same signal, and the committed files equal to the generator's; one
    acquire and one track wrapper run as the shell workloads run them
    (packet2wav_3ch.py into /dev/stdin), their rows the CLI's.
"""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.cli import acquire as acq_cli
from gnss_dsp_tpu_torch.cli import track as trk_cli
from gnss_dsp_tpu_torch.cli import workload
from gnss_dsp_tpu_torch.models import get_signal
from gnss_dsp_tpu_torch.tools.main_path import run_cli as _run_cli
from gnss_dsp_tpu_torch.track.driver import TrackChannel, track_file


def run_cli(main, *args, **kw):
    """What main(*args, **kw) printed (tools/main_path.run_cli)."""
    return _run_cli(lambda *a: main(*a, **kw), *args)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "gnss_dsp_tpu_torch")
FRAME = 2 * int(69.984e6 // 1000)


@pytest.fixture(scope="module")
def sky10(tmp_path_factory):
    """(port capture, root capture) of a 10 ms sky at 50 dB-Hz."""
    import tools.synth_sky as root_sky
    from gnss_dsp_tpu_torch.tools import synth_sky

    d = tmp_path_factory.mktemp("sky")
    a, b = str(d / "port.pcap"), str(d / "root.pcap")
    synth_sky.write_capture(a, 10, 50.0, progress=False)
    root_sky.write_capture(b, 10, 50.0, progress=False)
    return a, b


def test_synth_sky_is_the_root_tools(sky10):
    a, b = sky10
    assert os.path.getsize(a) == 3 * 10 * FRAME
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_demux_equals_the_reference(sky10, tmp_path):
    """packet2wav_3ch.py against the root tools/packet2wav_3ch (a
    trailing partial frame dropped); workload.demux_bands against the
    JAX package's."""
    from gnss_dsp_tpu.cli import workload as jwork

    with open(sky10[0], "rb") as f:
        raw = f.read() + b"\x01" * 1000
    for band in (1, 2, 3):
        outs = [subprocess.run([sys.executable, tool, str(band)], input=raw,
                               capture_output=True, timeout=120)
                for tool in (os.path.join(PORT, "tools", "packet2wav_3ch.py"),
                             os.path.join(ROOT, "tools", "packet2wav_3ch"))]
        assert outs[0].returncode == outs[1].returncode == 0
        assert outs[0].stdout == outs[1].stdout
        assert len(outs[0].stdout) == 10 * FRAME
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = workload.demux_bands(sky10[0], str(tmp_path / "p"))
    want = jwork.demux_bands(sky10[0], str(tmp_path / "j"))
    for band in (1, 2, 3):
        with open(got[band], "rb") as f, open(want[band], "rb") as g:
            assert f.read() == g.read()


def _gps_capture(path, seconds=0.12, fs=4.096e6, noise=0.5):
    from gnss_dsp_tpu_torch.utils import synth

    sig = get_signal("gps-l1")
    n = int(fs * seconds)
    x = np.zeros(n, np.complex64)
    for prn, dop, cp in ((3, 1000.0, 10.0), (7, -1500.0, 500.0)):
        x += synth.synth_iq(sig.code_table((prn,))[0], sig.chip_rate, fs, n,
                            doppler_hz=dop, code_phase=cp, cn0_dbhz=None,
                            carrier_ratio=1540.0)
    x += noise * (np.random.default_rng(5).standard_normal(n)
                  + 1j * np.random.default_rng(6).standard_normal(n))
    with open(path, "wb") as f:
        f.write(synth.to_int8_iq(x, scale=24.0))
    return path


ACQ_ARGS = ["--prn", "3,7,9", "--time", "4", "--doppler-search",
            "-2000,2000,500"]


def test_cached_acquire_rows_equal_the_uncached(tmp_path):
    path = _gps_capture(str(tmp_path / "g.iq"))
    argv = ACQ_ARGS + [path, "4096000", "0", "--device", "cpu"]
    plain = run_cli(acq_cli.main, "gps-l1", list(argv))
    cache = {}
    first = run_cli(acq_cli.main, "gps-l1", list(argv), x_cache=cache)
    assert list(cache) == [path] and cache[path].dtype == torch.complex64
    ent = cache[path]
    again = run_cli(acq_cli.main, "gps-l1", list(argv), x_cache=cache)
    assert cache[path] is ent                   # uploaded once
    assert plain == first == again and plain.count("\n") == 3
    # the serial branch reads through the same cache
    short = ACQ_ARGS[:2] + ["--time", "200", path, "4096000", "0",
                            "--device", "cpu"]
    for kw in ({}, {"x_cache": cache}):
        err = io.StringIO()
        saved = sys.stderr
        sys.stderr = err
        try:
            assert acq_cli.main("gps-l1", list(short), **kw) == 1
        finally:
            sys.stderr = saved
        assert err.getvalue() == "insufficient samples\n"


def _jax_rows(path, fs, preload):
    from gnss_dsp_tpu.cli import track as jcli
    from gnss_dsp_tpu.models import get_signal as jsig
    from gnss_dsp_tpu.track.driver import TrackChannel as JC
    from gnss_dsp_tpu.track.driver import track_file as jtrack

    ch = [JC(prn=3, doppler=1000.0, code_offset=10.0),
          JC(prn=7, doppler=-1500.0, code_offset=500.0)]
    pre = jcli._preload_chunk(path, fs, 2000.0, {}) if preload else None
    with open(path, "rb") as fp:
        jtrack(jsig("gps-l1"), fp, fs, 0.0, ch, preloaded=pre)
    return [c.rows for c in ch]


def _port_rows(path, fs, preloaded=None, **kw):
    ch = [TrackChannel(prn=3, doppler=1000.0, code_offset=10.0),
          TrackChannel(prn=7, doppler=-1500.0, code_offset=500.0)]
    with open(path, "rb") as fp:
        track_file(get_signal("gps-l1"), fp, fs, 0.0, ch, device="cpu",
                   preloaded=preloaded, **kw)
    return [c.rows for c in ch]


def _same_rows(got, want, blocks=40):
    """The int fields of every row equal; the floats of the first
    `blocks` rows at the tracking tolerance, rtol 2e-5 / atol 2e-4 (as
    tests/test_torch_track.py holds the plain scan to the XLA scan)."""
    for a_ch, b_ch in zip(got, want):
        assert len(a_ch) == len(b_ch) > blocks
        for i, (a, b) in enumerate(zip(a_ch, b_ch)):
            assert [a[k] for k in ("block", "samp", "code_cyc",
                                   "carrier_cyc")] == \
                [b[k] for k in ("block", "samp", "code_cyc", "carrier_cyc")]
            if i >= blocks:
                continue
            for k in ("p_re", "p_im", "carrier_f", "prompt", "code_p"):
                np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-4)


def test_preloaded_chunk_matches_jax_and_streaming(tmp_path):
    """The whole 0.12 s capture (noiseless) as one chunk: the pad rule,
    the rows of the JAX package's preloaded run (which equal its
    streaming rows), and the port's streaming rows bit for bit."""
    fs = 4.096e6
    path = _gps_capture(str(tmp_path / "g.iq"), noise=0.0)
    cache = {}
    x, n = trk_cli._preload_chunk(path, fs, 2000.0, cache, device="cpu")
    pad = int(fs * 0.006) + 16384
    pad += (-(n + pad)) % 1024
    assert n == int(fs * 0.12) and x.shape[0] == n + pad
    assert x.shape[0] % 1024 == 0 and float(x[n:].abs().max()) == 0.0
    assert trk_cli._preload_chunk(path, fs, 2000.0, cache,
                                  device="cpu")[0] is x
    assert trk_cli._preload_chunk(path, fs, 100.0, {}, device="cpu") is None
    got = _port_rows(path, fs, (x, n))
    assert len(got[0]) > 100
    want = _jax_rows(path, fs, True)
    assert want == _jax_rows(path, fs, False)
    _same_rows(got, want)
    assert got == _port_rows(path, fs)


def test_preload_gate_falls_through_to_the_stream(tmp_path):
    """A chunk of zeros that the gate must refuse (its rows would differ):
    a pad short of nmax, a length not a multiple of 1024, a checkpoint, a
    resume and a mesh each take the streaming reader; an accepted chunk
    never reads fp."""
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh

    fs = 4.096e6
    path = _gps_capture(str(tmp_path / "g.iq"), seconds=0.06)
    n = int(fs * 0.06)
    stream = _port_rows(path, fs)
    ok = torch.zeros(n + 7168 - (n % 1024), dtype=torch.complex64)
    assert ok.shape[0] % 1024 == 0 and ok.shape[0] >= n + 6148
    assert _port_rows(path, fs, (ok, n)) != stream     # accepted
    short = torch.zeros(n + 1024 - n % 1024, dtype=torch.complex64)
    odd = torch.zeros(n + 7000, dtype=torch.complex64)
    for pre in (short, odd):
        assert _port_rows(path, fs, (pre, n)) == stream
    ck = str(tmp_path / "ck.npz")
    assert _port_rows(path, fs, (ok, n), checkpoint_path=ck,
                      chunk_ms=20.0) == _port_rows(path, fs, chunk_ms=20.0)
    assert _port_rows(path, fs, (ok, n), resume_from=ck) == \
        _port_rows(path, fs, resume_from=ck)
    mesh = make_mesh(1, devices=[torch.device("cpu")])
    assert _port_rows(path, fs, (ok, n), mesh=mesh) == stream

    class Unread(io.RawIOBase):
        def read(self, *a):
            raise AssertionError("the preloaded run read fp")

    ch = [TrackChannel(prn=3, doppler=1000.0, code_offset=10.0)]
    x, m = trk_cli._preload_chunk(path, fs, 2000.0, {}, device="cpu")
    track_file(get_signal("gps-l1"), Unread(), fs, 0.0, ch, device="cpu",
               preloaded=(x, m), max_blocks=5)
    assert len(ch[0].rows) == 5


def test_cached_track_cli_rows_equal_the_uncached(tmp_path):
    """cli.track.main with the workload's cache, single and `multi`,
    prints the uncached rows; one upload for both."""
    path = _gps_capture(str(tmp_path / "g.iq"), seconds=0.05)
    argv = [path, "4096000", "0", "3", "1000.0", "10.0", "--device", "cpu"]
    cache = {}
    assert run_cli(trk_cli.main, "gps-l1", list(argv), x_cache=cache) == \
        run_cli(trk_cli.main, "gps-l1", list(argv))
    ent = cache[path]
    multi = [path, "4096000", "0", "gps-l1:3:1000:10,gps-l1:7:-1500:500",
             "--device", "cpu"]
    assert run_cli(trk_cli.main, "multi", list(multi), x_cache=cache) == \
        run_cli(trk_cli.main, "multi", list(multi))
    assert cache[path] is ent


def _container(path, ms=3, seed=4):
    raw = np.random.default_rng(seed).integers(-128, 128, 3 * ms * FRAME,
                                               dtype=np.int64)
    raw.astype(np.int8).tofile(path)
    return raw.astype(np.int8).reshape(ms, 3, FRAME)


def test_workload_runner_drives_every_script(tmp_path, monkeypatch):
    """cli.workload all on a 3 ms container, the CLI mains replaced by
    recorders: each gets the shell scripts' argv plus --device, its
    band's demuxed file and the one shared cache of its stage, in the
    shell scripts' order; each file holds what its main printed."""
    frames = _container(str(tmp_path / "c.pcap"))
    calls = []

    def acq(signal, argv, x_cache=None):
        calls.append(("acq", signal, list(argv), x_cache, None))
        print(f"{signal} {' '.join(argv[1:])}")
        return 0

    def trk(signal, argv, x_cache=None):
        calls.append(("trk", signal, list(argv), x_cache, None))
        print(f"{signal} {' '.join(argv[1:])}")
        return None

    monkeypatch.setattr(acq_cli, "main", acq)
    monkeypatch.setattr(trk_cli, "main", trk)
    dest = str(tmp_path / "out")
    assert workload.main(["--device", "cpu", "all", str(tmp_path / "c.pcap"),
                          dest]) == 0
    for b in (1, 2, 3):
        with open(os.path.join(dest, f"band{b}.iq"), "rb") as f:
            assert f.read() == frames[:, b - 1].tobytes()
    acqs = [c for c in calls if c[0] == "acq"]
    trks = [c for c in calls if c[0] == "trk"]
    assert [c[1] for c in acqs] == [r[1] for r in workload.ACQUIRE_ALL]
    assert [c[1] for c in trks] == [r[1] for r in workload.TRACK_ALL]
    assert len({id(c[3]) for c in acqs}) == 1 and acqs[0][3] == {}
    assert len({id(c[3]) for c in trks}) == 1 and trks[0][3] is not None
    for (_, signal, argv, _, _), row in zip(acqs, workload.ACQUIRE_ALL):
        assert argv == [os.path.join(dest, f"band{row[0]}.iq"), "69984000",
                        row[2], "--device", "cpu"]
        with open(os.path.join(dest, row[3])) as f:
            assert f.read() == f"{signal} 69984000 {row[2]} --device cpu\n"
    by_file = {r[6]: r for r in workload.TRACK_ALL}
    for name, row in by_file.items():
        want = [os.path.join(dest, f"band{row[0]}.iq"), "69984000",
                *row[2:6], "--device", "cpu"]
        assert [row[1], want] in [[c[1], c[2]] for c in trks]
        with open(os.path.join(dest, name)) as f:
            assert f.read() == f"{row[1]} {' '.join(want[1:])}\n"


def test_sky_workload_validate(tmp_path):
    """validate on output files planted at the golden seeds passes; a
    wrong PRN, a track off its doppler, and a missing PRN row fail."""
    from gnss_dsp_tpu_torch.tools import sky_workload as sw

    d = str(tmp_path)
    for _b, signal, _co, fn in workload.ACQUIRE_ALL:
        sig = get_signal(signal)
        want = sw.ACQ_EXPECT.get(fn)
        with open(os.path.join(d, fn), "w") as f:
            for p in sig.prns():
                hit = want is not None and p == want[0]
                f.write("prn %3d doppler % 7.1f metric % 7.1f code_offset "
                        "%7.2f\n" % (p, want[1] if hit else 0.0,
                                     9.0 if hit else 1.0,
                                     want[2] if hit else 0.0))
    for fn, dop in sw.TRACK_EXPECT.items():
        rows = np.zeros((80, 9))
        rows[:, 3] = dop
        rows[:, 7] = 2.0
        rows[:, 6] = rows[:, 8] = 1.0
        np.savetxt(os.path.join(d, fn), rows)
    lines, fails = sw.validate(d)
    assert not fails and len(lines) == 32
    assert len(sw.output_files()) == 32
    with open(os.path.join(d, "acq-gps-l1.dat"), "a") as f:
        f.write("prn  33 doppler  2400.0 metric    99.0 code_offset  817.50\n")
    with open(os.path.join(d, "acq-gps-l5q.dat")) as f:
        keep = f.readlines()[:-1]
    with open(os.path.join(d, "acq-gps-l5q.dat"), "w") as f:
        f.writelines(keep)
    rows[:, 3] = 0.0
    np.savetxt(os.path.join(d, "track-gps-l1-prn21.dat"), rows)
    assert sorted(sw.validate(d)[1]) == ["acq-gps-l1.dat", "acq-gps-l5q.dat",
                                         "track-gps-l1-prn21.dat"]


def test_container_synthesised_on_the_device_demuxes_to_its_bands(
        tmp_path):
    """sky_workload.synth_on_device on the CPU at 3 ms: the container
    demuxes (cli.workload.demux_bands) to exactly the bands that
    receiver_sky.synth_bands writes."""
    from gnss_dsp_tpu_torch.tools import sky_workload as sw
    from gnss_dsp_tpu_torch.tools.receiver_sky import BANDS, synth_bands

    out = str(tmp_path / "sky.pcap")
    assert sw.synth_on_device(out, 3, 45.0, "cpu") == 3
    assert os.path.getsize(out) == 3 * 3 * FRAME
    assert sorted(os.listdir(tmp_path)) == ["sky.pcap"]
    paths = {b: str(tmp_path / f"want{b}.iq") for b in BANDS}
    synth_bands(paths, 0.003, cn0=45.0, device="cpu")
    (tmp_path / "d").mkdir()
    got = workload.demux_bands(out, str(tmp_path / "d"))
    for b in BANDS:
        with open(got[b], "rb") as f, open(paths[b], "rb") as g:
            assert f.read() == g.read()


def _wrapper_call(text):
    """(module, signal or None) a drop-in wrapper delegates to."""
    mod = re.search(r"from gnss_dsp_tpu(?:_torch)?\.cli\.(\w+) import main",
                    text).group(1)
    sig = re.search(r"main\('([\w-]+)', sys\.argv", text)
    return mod, sig.group(1) if sig else None


def test_drop_in_wrappers_name_the_reference_signals(tmp_path):
    from gnss_dsp_tpu_torch.tools import gen_compat_scripts as gen

    root = sorted(os.listdir(os.path.join(ROOT, "scripts")))
    port_dir = os.path.join(PORT, "scripts")
    port = sorted(os.listdir(port_dir))
    assert len(root) == 68
    assert port == sorted(root + ["acquire-all.sh",
                                  "track-all-gnss-2017-L1L2L5.sh"])
    for name in root:
        with open(os.path.join(ROOT, "scripts", name)) as f, \
                open(os.path.join(port_dir, name)) as g:
            text = g.read()
            assert _wrapper_call(text) == _wrapper_call(f.read()), name
            assert "gnss_dsp_tpu_torch" in text
            assert "gnss_dsp_tpu." not in text
    gen.main([str(tmp_path)])
    for name in port:
        with open(os.path.join(port_dir, name)) as f, \
                open(tmp_path / name) as g:
            assert f.read() == g.read(), f"{name}: rerun gen_compat_scripts"


WRAPPER_RUNS = {
    "acquire": ("acquire-gps-l1.py", acq_cli.main, "gps-l1",
                ACQ_ARGS + ["{src}", "4096000", "0"]),
    "track": ("track-gps-l1.py", trk_cli.main, "gps-l1",
              ["--blocks", "30", "{src}", "4096000", "0", "3", "1000.0",
               "10.0"]),
}


@pytest.mark.parametrize("kind", sorted(WRAPPER_RUNS))
def test_drop_in_wrapper_runs_as_the_cli(tmp_path, kind):
    """One acquire and one track wrapper run as the shell workloads run
    them: band 1 of a container demuxed by packet2wav_3ch.py into the
    wrapper's /dev/stdin, a process each, --device cpu.  Their stdout
    equals the direct CLI call's on the demuxed band file."""
    script, main, signal, args = WRAPPER_RUNS[kind]
    with open(_gps_capture(str(tmp_path / "g.iq")), "rb") as f:
        band = f.read()
    band += b"\0" * (-len(band) % FRAME)
    frames = len(band) // FRAME
    rest = np.random.default_rng(8).integers(-128, 128, (frames, 2, FRAME),
                                             dtype=np.int64).astype(np.int8)
    cont = np.concatenate([np.frombuffer(band, np.int8).reshape(frames, 1,
                                                                 FRAME),
                           rest], axis=1)
    container = tmp_path / "c.pcap"
    cont.tofile(container)
    (tmp_path / "band1.iq").write_bytes(band)
    p2w = os.path.join(PORT, "tools", "packet2wav_3ch.py")
    wrapper = os.path.join(PORT, "scripts", script)
    argv = [a.format(src="/dev/stdin") for a in args] + ["--device", "cpu"]
    cmd = (f'<"{container}" "{sys.executable}" "{p2w}" 1 | '
           f'"{sys.executable}" "{wrapper}" ' + " ".join(argv))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(["sh", "-c", cmd], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr
    want = run_cli(main, signal, [a.format(src=str(tmp_path / "band1.iq"))
                                  for a in args] + ["--device", "cpu"])
    assert out.stdout == want and want.count("\n") >= 3


def test_shell_workloads_are_the_reference_rows():
    """Each line of the port's shell workloads runs the root workload's
    script with the same argv (the demuxer and script directory the
    port's, --device passed), in the same order."""
    def rows(path, port):
        out = []
        with open(path) as f:
            for line in f:
                m = re.match(r'<"\$\{DATA\}" (?:\$P2W|packet2wav_3ch) (\d) \| '
                             r'python3? "\$S"/(\S+) (.*?)'
                             r'( --device "\$DEVICE")? *>"\$\{DEST_DIR\}"/'
                             r'(\S+)$', line.strip())
                if m:
                    assert bool(m.group(4)) == port
                    out.append((m.group(1), m.group(2),
                                m.group(3).split(), m.group(5)))
        return out

    for name in ("acquire-all.sh", "track-all-gnss-2017-L1L2L5.sh"):
        got = rows(os.path.join(PORT, "scripts", name), True)
        want = rows(os.path.join(ROOT, name), False)
        assert got == want and len(got) in (21, 11)
