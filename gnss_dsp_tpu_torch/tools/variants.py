"""What the build-variant tools share (k1_variants, k2_variants,
k3_variants, surface_variants): a copy of a tree's csrc with text patches,
built and run by that tree's own code in a fresh interpreter on the card.

A patch is (file, old, new): `old` must be found in the file exactly once,
so a patch that no longer fits its source fails instead of building the
unpatched kernel.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys


def repo_root() -> str:
    """The root of the repository this package lies in."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def prepare(tree: str, work: str, patches=(), name: str = "") -> str:
    """WORK/csrc: a copy of TREE's gnss_dsp_tpu_torch/csrc with `patches`
    applied (WORK emptied first); returns its path."""
    csrc = os.path.join(work, "csrc")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "gnss_dsp_tpu_torch", "csrc"), csrc)
    for fname, old, new in patches:
        path = os.path.join(csrc, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name} patch of {fname}: {old!r} found "
                               f"{text.count(old)} times")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return csrc


def run_child(child: str, args, cwd: str, tag: str, name: str,
              timeout: float | None = None):
    """Run `python -c CHILD *ARGS` in CWD; returns (the JSON object of its
    stdout line that starts with "TAG ", its stdout lines).  Exits with
    the child's output tails where it fails or prints no such line."""
    r = subprocess.run([sys.executable, "-c", child, *map(str, args)],
                       cwd=cwd, capture_output=True, text=True,
                       timeout=timeout)
    lines = r.stdout.splitlines()
    got = [x for x in lines if x.startswith(tag + " ")]
    if r.returncode != 0 or not got:
        print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"{name} failed ({r.returncode})")
    return json.loads(got[-1][len(tag) + 1:]), lines
