"""Kernel K2 (ops/track_fused.track_scan_fused -> csrc/track_fused.cu):
the sum of each launch's roofline bound over the sum of its device time,
in %.

Device time: CUDA events around every call in the traced run.  Bound:
gnssbench/roofline.k2_bound (a frozen copy of chip_smoke.py's k2_bound
and sample_ops) at the launch's chunk, the chips its channels' lags
touch, the rows written and the samples tracked (read from the launch's
int rows after the window), against the published H100 SXM peaks."""

import numpy as np

from gnssbench import roofline

TRACE = ("track_fused_kernel",)
SIGP_CF_HI, SIGP_L = 0, 3         # the sigp lanes of chip rate / fs, L


def bound(args, kwargs, out):
    x_numel = int(args[0].numel())
    params, sigp, rows_i = args[4], args[8], out[2]
    sub = str(params.subcarrier)
    kind = sub if sub in ("none", "tmboc") else "subc"

    def later():
        ri = rows_i.cpu().numpy()
        sp = sigp.cpu().numpy()
        ns = ri[..., 0].astype(np.int64).sum(0)
        chips = sum(min(int(sp[c, SIGP_L]), int(ns[c] * float(sp[c, SIGP_CF_HI])) + 3)
                    for c in range(len(ns)))
        rows = int((ri[..., 0] > 0).sum())
        return roofline.k2_bound(x_numel, chips, rows, float(ns.sum()),
                                 kind)[0]
    return later


KERNELS = [dict(where="gnss_dsp_tpu_torch.ops.track_fused",
                attr="track_scan_fused", name="k2", trace=TRACE,
                bound=bound)]


def read(ctx):
    return ctx.roofline("k2")
