"""Time build variants of kernel K1 (csrc/acquire2.cu) on the card.

    python -m gnss_dsp_tpu_torch.tools.k1_variants
        [--variants base,code_regs,prns2]

For each variant this tool copies the package's csrc to
_work/k1_variants/NAME/csrc, patches it, builds it there with
ops/_build.py, and runs chip_smoke.py's k1 case in a fresh interpreter at
the GPS L1 sky-search shape (32 PRN x 70 doppler x 80 blocks x 4096) and
the non-coherent BeiDou B1I shape (63 x 70 x 40 x 16384): the kernel held
against its plain version (planted lags exact, peak and sum rtol 1e-4,
two launches bit-equal), then timed with CUDA events, with the other
cluster sizes built at 4096.

  base       the sources as they are
  code_regs  4096 on 2 CTAs and 16384 on 8 with each thread's code values
             in registers (kCodeRegs), as the choices at 32768 and 65536
  prns2      two PRNs a cluster at 4096: the staged row of F feeds the
             transforms of both in turn (a second code slice in shared
             memory, two sets of lag sums in registers, half the clusters)

It prints one JSON line per variant (the cases' times and plans, and
ptxas's registers and spills of the K1 kernels), then the nvidia-smi name
and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

from gnss_dsp_tpu_torch.ops._build import ptxas_summary

VARIANTS = ("base", "code_regs", "prns2")

# (file, old, new): each old must be found exactly once
PATCHES = {
    "code_regs": (
        ("acquire2.cu",
         "case 0: case 2: l = split_of<Spec<12, 2>>(); return true;",
         "case 0: case 2: l = split_of<Spec<12, 2, true>>(); return true;"),
        ("acquire2.cu", "      l = split_of<Spec<14, 8>>();",
         "      l = split_of<Spec<14, 8, true>>();"),
    ),
    "prns2": (
        ("acq_cluster.cuh", "  static constexpr int kOffCode = E;",
         "  static constexpr int kQ = W == 4096 ? 2 : 1;   // PRNs a cluster\n"
         "  static constexpr int kOffCode = E;"),
        ("acq_cluster.cuh",
         "  static constexpr int kOffXb = kCodeRegs ? E : 2 * E, "
         "kOffYb = kOffXb + E;",
         "  static constexpr int kOffXb = kCodeRegs ? E : (1 + kQ) * E, "
         "kOffYb = kOffXb + E;"),
        ("acq_cluster.cuh",
         "  const int p = item % s.P;\n  const int d = item / s.P;",
         "  constexpr int kQ = kAlign ? 1 : K::kQ;\n"
         "  const int p = kQ * (item % (s.P / kQ));\n"
         "  const int d = item / (s.P / kQ);"),
        ("acq_cluster.cuh",
         "      code[e] = __ldg(cf + c + (size_t)N2 * k1);",
         "      for (int q = 0; q < kQ; ++q)\n"
         "        code[q * K::E + e] = __ldg(cf + (size_t)q * W + c +"
         " (size_t)N2 * k1);"),
        ("acq_cluster.cuh", "  float acc[RO2];\n",
         "  float acc_q[kQ][RO2];\n  float (&acc)[RO2] = acc_q[0];\n"),
        ("acq_cluster.cuh",
         "    for (int o = 0; o < RO2; ++o) acc[o] = 0.f;",
         "    for (int o = 0; o < kQ * RO2; ++o) acc_q[o / RO2][o % RO2] = 0.f;"),
        ("acq_cluster.cuh",
         "    for (int g = 0; g < G; ++g) {\n      cp_async_wait_all();\n",
         "    for (int g = 0; g < G; ++g) {\n#pragma unroll\n"
         "    for (int q = 0; q < kQ; ++q) {\n"
         "      if (q == 0) cp_async_wait_all();\n"),
        ("acq_cluster.cuh", "          else c = code[e];",
         "          else c = code[q * K::E + e];"),
        ("acq_cluster.cuh",
         "      if (g + 1 < G)\n        stage_row((g + 1) * A + a);",
         "      if (q + 1 < kQ) {\n      } else if (g + 1 < G)\n"
         "        stage_row((g + 1) * A + a);"),
        ("acq_cluster.cuh",
         "          acc[o] += cabs_approx(z[o]);\n      }\n    }\n",
         "          acc_q[q][o] += cabs_approx(z[o]);\n      }\n    }\n"
         "    }\n"),
        ("acq_cluster.cuh", "  Best b = {-INFINITY, W, 0, 0.f};",
         "  for (int q = 0; q < kQ; ++q) {\n"
         "  Best b = {-INFINITY, W, 0, 0.f};"),
        ("acq_cluster.cuh", "      else val = acc[o];",
         "      else val = acc_q[q][o];"),
        ("acq_cluster.cuh",
         "    const size_t o = (size_t)p * s.DC + d;\n"
         "    s.peak[o] = b.v / (float)W;",
         "    const size_t o = (size_t)(p + q) * s.DC + d;\n"
         "    s.peak[o] = b.v / (float)W;"),
        ("acq_cluster.cuh",
         "    if constexpr (kSum) s.sum[o] = b.s / (float)W;\n"
         "  }\n}",
         "    if constexpr (kSum) s.sum[o] = b.s / (float)W;\n"
         "  }\n  }\n}"),
        ("acquire2.cu",
         "    const long long grid = (long long)P * DC * l.C;",
         "    if (W == 4096 && P % 2) return (int)cudaErrorInvalidValue;\n"
         "    const long long grid = (long long)(W == 4096 ? P / 2 : P) * DC"
         " * l.C;"),
    ),
}

# run in a fresh interpreter at the repository root: argv = csrc build
CHILD = r"""
import json, sys
csrc, build = sys.argv[1:3]
sys.path.insert(0, ".")
from gnss_dsp_tpu_torch.ops import _build as b
b.CSRC, b.BUILD_DIR = csrc, build
b.load()
import torch
import chip_smoke as cs
card = cs.card_line()
dev = torch.device("cuda", 0)
cases = [cs._k1_case(dev, card, "gps-l1", 32, 70, 80, 4096, 1234, 5),
         cs._k1_case(dev, card, "beidou-b1i", 63, 70, 40, 16384, 4321, 8)]
print("VARIANT " + json.dumps(dict(card=card, cases=cases,
                                   log=b.BUILD_INFO["log"])))
"""


def prepare(root: str, name: str) -> str:
    """ROOT/_work/k1_variants/NAME/csrc, a copy of the package's csrc
    with the variant's patches; returns its path."""
    base = os.path.join(root, "_work", "k1_variants", name)
    csrc = os.path.join(base, "csrc")
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(os.path.join(root, "gnss_dsp_tpu_torch", "csrc"), csrc)
    for fname, old, new in PATCHES.get(name, ()):
        path = os.path.join(csrc, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name} patch of {fname}: {old!r} found "
                               f"{text.count(old)} times")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return csrc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = None
    for name in args.variants.split(","):
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}: {VARIANTS}")
        csrc = prepare(root, name)
        build = os.path.join(os.path.dirname(csrc), "build")
        r = subprocess.run([sys.executable, "-c", CHILD, csrc, build],
                           cwd=root, capture_output=True, text=True)
        line = [x for x in r.stdout.splitlines() if x.startswith("VARIANT ")]
        if r.returncode != 0 or not line:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"variant {name} failed ({r.returncode})")
        got = json.loads(line[0][len("VARIANT "):])
        card = got["card"]
        print(json.dumps(dict(
            variant=name,
            cases=[{k: c[k] for k in ("ms", "plain_ms", "library_ms",
                                      "max_abs_err")} for c in got["cases"]],
            k1_kernels=ptxas_summary(got["log"], r"acq2_split_kernel"),
            k1_log=[x for x in r.stdout.splitlines()
                    if x.startswith("[k1]")])), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
