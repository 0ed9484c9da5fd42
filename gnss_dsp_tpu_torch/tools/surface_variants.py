"""Time build variants of the surface kernels K5 and K7 of a checkout.

    python -m gnss_dsp_tpu_torch.tools.surface_variants TREE
        [--variants base,fma,fma_twsmem]

TREE is a checkout of this repository from before the cluster redesign of
K5 and K7 (for example the parent commit unpacked with git archive into a
directory under _work/).  For each variant this tool copies TREE's
gnss_dsp_tpu_torch/csrc to TREE/_work/variants/NAME, builds it there
with TREE's own ops/_build.py, and runs TREE's own chip_smoke phases k7
and k5 (the kernel held against its plain version at the e2e shapes,
then timed with CUDA events) in a fresh interpreter:

  base        the sources and flags as TREE has them
  fma         acquire.cu and acquire_coh.cu without --fmad=false
  fma_twsmem  as fma, and where the whole twiddle table of the
              shared-memory IDFT does not fit beside the row
              (acq_surface.cuh, W = 16384), the tables of every pass but
              the last sit in shared memory (4384 of 20768 entries)

It prints one JSON line per variant (kernel, plain and library ms, and
the registers, spills and shared memory nvcc -Xptxas -v gives the
surface kernels), then the nvidia-smi name and power limit.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gnss_dsp_tpu_torch.ops._build import ptxas_summary
from gnss_dsp_tpu_torch.tools.variants import prepare, run_child

VARIANTS = ("base", "fma", "fma_twsmem")

# the twsmem patch of TREE's csrc/acq_surface.cuh (tools/variants.prepare)
TWSMEM_PATCH = tuple(("acq_surface.cuh", old, new) for old, new in (
    ("""__device__ void ifft_inplace(float2* buf, const float2* tw,
                             const float2* w16, int W) {""",
     """__device__ void ifft_inplace(float2* buf, const float2* tw,
                             const float2* w16, int W, const float2* twg,
                             int nsm) {"""),
    ("""    const int r = (W / ns < 16) ? W / ns : 16;
    switch (r) {""",
     """    const int r = (W / ns < 16) ? W / ns : 16;
    const float2* tp = off + r * ns <= nsm ? tw + off : twg + off;
    switch (r) {"""),
    ("case 16: pass_inplace<16, T, PER>(buf, tw + off,",
     "case 16: pass_inplace<16, T, PER>(buf, tp,"),
    ("case 8: pass_inplace<8, T, PER>(buf, tw + off,",
     "case 8: pass_inplace<8, T, PER>(buf, tp,"),
    ("case 4: pass_inplace<4, T, PER>(buf, tw + off,",
     "case 4: pass_inplace<4, T, PER>(buf, tp,"),
    ("default: pass_inplace<2, T, PER>(buf, tw + off,",
     "default: pass_inplace<2, T, PER>(buf, tp,"),
    ("  const int ntw = s.tw_in_smem ? twiddle_count(W) : 16;",
     "  const int ntw = s.tw_in_smem == 1 ? twiddle_count(W)\n"
     "                  : s.tw_in_smem == 2 ? twiddle_count(W) - W : 16;"),
    ("    ifft_inplace<T, PER>(buf, tw, w16, W);",
     "    ifft_inplace<T, PER>(buf, tw, w16, W, s.tw,\n"
     "                         s.tw_in_smem ? ntw : 1 << 30);"),
    ("""  const size_t shmem = surface_smem(s.W, ntw, s.tw_in_smem,""",
     """  if (!s.tw_in_smem && KIND == kRows &&
      surface_smem(s.W, ntw - s.W, 1, 0) <= 227 * 1024)
    s.tw_in_smem = 2;
  const size_t shmem = surface_smem(
      s.W, s.tw_in_smem == 2 ? ntw - s.W : ntw, s.tw_in_smem,"""),
))

FMA_SOURCES = ("acquire.cu", "acquire_coh.cu")

# run in a fresh interpreter inside TREE: argv = tree csrc build fma
CHILD = r"""
import json, os, sys
tree, csrc, build, fma = sys.argv[1:5]
sys.path.insert(0, tree)
os.chdir(tree)
from gnss_dsp_tpu_torch.ops import _build as b
b.CSRC, b.BUILD_DIR = csrc, build
if fma == "1":
    run = b._run_all
    def _run_all(cmds):
        return run([[a for a in c if a != "--fmad=false"]
                    if c[-1].endswith(%r) else c for c in cmds])
    b._run_all = _run_all
b.load()
import torch
import chip_smoke as cs
card = cs.card_line()
res = {k: dict(name=k) for k in ("acquire", "acquire_coh_spec")}
cs.phase_k7(torch.device("cuda", 0), card, res)
cs.phase_k5(torch.device("cuda", 0), card, res)
print("VARIANT " + json.dumps(dict(card=card, results=res,
                                   log=b.BUILD_INFO["log"])))
""" % (FMA_SOURCES,)


def run_variant(tree: str, name: str) -> dict:
    work = os.path.join(tree, "_work", "variants", name)
    csrc = prepare(tree, work,
                   TWSMEM_PATCH if name.endswith("twsmem") else (), name)
    got, _ = run_child(CHILD, (tree, csrc, os.path.join(work, "build"),
                               "1" if name.startswith("fma") else "0"),
                       tree, "VARIANT", f"variant {name}", timeout=1200)
    keep = ("ms", "plain_ms", "library_ms", "max_abs_err")
    return dict(
        variant=name, card=got["card"],
        kernels={k: {f: v.get(f) for f in keep}
                 for k, v in got["results"].items()},
        ptxas=ptxas_summary(got["log"], r"surface_kernel|wide_kernel"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    card = None
    for name in args.variants.split(","):
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}; one of {VARIANTS}")
        out = run_variant(tree, name)
        card = out["card"]
        print(json.dumps(out), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
