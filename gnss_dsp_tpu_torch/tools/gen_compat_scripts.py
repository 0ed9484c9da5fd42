"""Generate the port's drop-in scripts in gnss_dsp_tpu_torch/scripts/.

Counterpart: tools/gen_compat_scripts.py of the repository root.  One
wrapper per reference script name (32 acquire, 33 track and the three
utilities cn0, spectrum and squaring: the 68 names of the root scripts/),
each delegating to the port's CLI with its catalog signal and the
reference's name quirks (acquire-xona-x1.py searches the x1p code); and
the two shell workloads, acquire-all.sh and
track-all-gnss-2017-L1L2L5.sh, built from cli/workload's ACQUIRE_ALL and
TRACK_ALL, with this directory as their script directory and
tools/packet2wav_3ch.py as their demuxer.

    python -m gnss_dsp_tpu_torch.tools.gen_compat_scripts [OUT_DIR]

The wrappers take the reference's argv, and --device anywhere (default
cuda, or cpu while GNSS_DSP_CPU is set); the shell workloads take DATA
[DEST_DIR [DEVICE]], DEVICE likewise.
"""

from __future__ import annotations

import os
import stat
import sys

from gnss_dsp_tpu_torch.cli.workload import (
    ACQUIRE_ALL, TRACK_ALL, acquire_argv, track_argv)

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(os.path.dirname(HERE), "scripts")

ACQUIRE = [
    "gps-l1", "gps-l1cd", "gps-l1cp", "gps-l2cl", "gps-l2cm", "gps-l5i",
    "gps-l5q",
    "galileo-e1b", "galileo-e1c", "galileo-e5ai", "galileo-e5aq",
    "galileo-e5bi", "galileo-e5bq", "galileo-e6b", "galileo-e6c",
    "beidou-b1cd", "beidou-b1cp", "beidou-b1i", "beidou-b2ad",
    "beidou-b2ap", "beidou-b2bi", "beidou-b2bq", "beidou-b2i",
    "beidou-b3i",
    "glonass-l1", "glonass-l1-p", "glonass-l2", "glonass-l2-p",
    "glonass-l3ocd", "glonass-l3ocp",
]
# the reference's name quirks: acquire-xona-x1.py searches the x1p code
ACQUIRE_ALIASES = {"xona-x1": "xona-x1p", "xona-x5p": "xona-x5p"}
TRACK = ACQUIRE
TRACK_ALIASES = {"xona-x1d": "xona-x1d", "xona-x1p": "xona-x1p",
                 "xona-x5p": "xona-x5p"}
UTILITIES = ("cn0", "spectrum", "squaring")

HEAD = """#!/usr/bin/env python3
# Drop-in replacement for the reference script of the same name, on the
# PyTorch/CUDA port.
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
"""
TEMPLATE = HEAD + """from gnss_dsp_tpu_torch.cli.{mod} import main
sys.exit(main({sig!r}, sys.argv[1:]))
"""
UTIL_TEMPLATE = HEAD + """from gnss_dsp_tpu_torch.cli.{mod} import main
sys.exit(main(sys.argv[1:]))
"""

SHELL_HEAD = """#!/bin/sh
# {what} on the PyTorch/CUDA port (behavioral
# contract: the reference's {name}).  Generated by
# gnss_dsp_tpu_torch/tools/gen_compat_scripts.py from cli/workload.py's
# {table}.
#
#   sh {name} DATA [DEST_DIR [DEVICE]]
#
# DEVICE: cuda or cpu (default cuda, or cpu while GNSS_DSP_CPU is set).
# DATA is the three-band 69.984 MHz container (tools/synth_sky.py), each
# band demuxed by tools/packet2wav_3ch.py, one process a script.

DATA=$1
DEST_DIR=${{2:-{dest}}}
DEVICE=${{3:-cuda}}
if [ -z "$3" ] && [ -n "$GNSS_DSP_CPU" ]; then
    DEVICE=cpu
    echo "{name}: GNSS_DSP_CPU is set: every script runs on the CPU (the plain versions); DEVICE overrides it" >&2
fi
S=$(dirname "$0")
P2W="python3 $S/../tools/packet2wav_3ch.py"
mkdir -p "${{DEST_DIR}}"
set -e
"""


def _line(band, script, argv, outfile):
    args = " ".join(["/dev/stdin"] + argv[1:])
    return (f'<"${{DATA}}" $P2W {band} | python3 "$S"/{script} {args} '
            f'--device "$DEVICE" >"${{DEST_DIR}}"/{outfile}\n')


def acquire_all_sh() -> str:
    text = SHELL_HEAD.format(what="Full-sky acquisition workload",
                             name="acquire-all.sh", table="ACQUIRE_ALL",
                             dest="acq-out")
    for row in ACQUIRE_ALL:
        text += _line(row[0], f"acquire-{row[1]}.py", acquire_argv(row, ""),
                      row[3])
    return text


def track_all_sh() -> str:
    text = SHELL_HEAD.format(what="Tracking workload of the golden seeds",
                             name="track-all-gnss-2017-L1L2L5.sh",
                             table="TRACK_ALL", dest="track-out")
    for row in TRACK_ALL:
        text += _line(row[0], f"track-{row[1]}.py", track_argv(row, ""),
                      row[6])
    return text


def files() -> dict:
    """{file name: text} of everything the generator writes."""
    out = {}
    for name, sig in [(s, s) for s in ACQUIRE] + list(ACQUIRE_ALIASES.items()):
        out[f"acquire-{name}.py"] = TEMPLATE.format(mod="acquire", sig=sig)
    for name, sig in [(s, s) for s in TRACK] + list(TRACK_ALIASES.items()):
        out[f"track-{name}.py"] = TEMPLATE.format(mod="track", sig=sig)
    for mod in UTILITIES:
        out[f"{mod}.py"] = UTIL_TEMPLATE.format(mod=mod)
    out["acquire-all.sh"] = acquire_all_sh()
    out["track-all-gnss-2017-L1L2L5.sh"] = track_all_sh()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else OUT
    os.makedirs(out, exist_ok=True)
    made = files()
    for name, text in made.items():
        path = os.path.join(out, name)
        with open(path, "w") as f:
            f.write(text)
        os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP)
    print("wrote", len(made), "files to", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
