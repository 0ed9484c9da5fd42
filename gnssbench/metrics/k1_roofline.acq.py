"""Kernel K1 (ops/acquire2.corr_surface2 -> csrc/acquire2.cu): the sum
of each call's roofline bound over the sum of its device time, in %.

Device time: CUDA events around every call in the traced run.  Bound:
gnssbench/roofline.surface_bound (a frozen copy of chip_smoke.py's) at
the call's [P, DC, B, W], the work the surface needs whatever computes
it, against the published H100 SXM peaks."""

from gnssbench import roofline

TRACE = ("acq2_split_kernel", "acq2_wide_kernel")


def bound(args, kwargs, out):
    F, code_f = args[0], args[1]
    reduce = args[3] if len(args) > 3 else kwargs.get("reduce", True)
    DC, B, W = F.shape
    return roofline.k1_call_bound_ms(DC, B, W, code_f.shape[0], reduce)


KERNELS = [dict(where="gnss_dsp_tpu_torch.ops.acquire2",
                attr="corr_surface2", name="k1", trace=TRACE, bound=bound)]


def read(ctx):
    return ctx.roofline("k1")
