"""Kernel K1 (ops/acquire2.corr_surface2 -> csrc/acquire2.cu) against the
work each search needs: the sum of each call's roofline bound over the
sum of its device time, in %.

Device time: CUDA events around every call in the traced run (the split
and the wide kernels alike).  Bound: gnssbench/roofline.k1_call_bound_ms
at the search's own window: F's W on the circular searches, 2 n_valid on
the v2p route, whose 2n windows (61380) K1 pads to a length with an
aligned split (65536) and whose reduction it masks to the n_valid exact
lags; the padding is the kernel's choice, not work the search needs."""

from gnssbench import roofline

TRACE = ("acq2_split_kernel", "acq2_wide_kernel")


def bound(args, kwargs, out):
    F, code_f = args[0], args[1]
    n_valid = args[2] if len(args) > 2 else kwargs.get("n_valid", 0)
    reduce = args[3] if len(args) > 3 else kwargs.get("reduce", True)
    DC, B, W = F.shape
    return roofline.k1_call_bound_ms(DC, B, 2 * n_valid if n_valid else W,
                                     code_f.shape[0], reduce)


KERNELS = [dict(where="gnss_dsp_tpu_torch.ops.acquire2",
                attr="corr_surface2", name="k1_search", trace=TRACE,
                bound=bound)]


def read(ctx):
    return ctx.roofline("k1_search")
