"""Kernel K5 (ops/acquire_coh.corr_surface_coh_spec ->
csrc/acquire_coh_spec.cu): the sum of each call's roofline bound over the
sum of its device time, in %.

Device time: CUDA events around every call in the traced run (the
register and the run-time core alike).  Bound: gnssbench/roofline.
surface_bound at the call's [P, DC, G*A, W_eff] with the reduction's
three [P, DC] outputs: F2's rows are the (group, alignment) rows the
overlay combine hands the kernel, and W_eff is 2 n_valid on a padded
window (the search's own 2n lags; the padding is the kernel's choice),
else F2's W.  At B1I --coherent 20's launch, 63 x 51 x 40 x 16384, it
is 2.546 ms, bound by the operations."""

from gnssbench import roofline

TRACE = ("coh_spec_kernel", "coh_wide_kernel")


def k5_call_bound_ms(P, DC, rows, W):
    """K5's bound for one call on F2 [DC, rows, W] and code spectra
    [P, W]: surface_bound with the (peak, lag, alignment) outputs."""
    return roofline.surface_bound(P, DC, rows, W, P * DC * 12)[0]


def bound(args, kwargs, out):
    f2, code_f = args[0], args[1]
    n_valid = args[3] if len(args) > 3 else kwargs.get("n_valid", 0)
    DC, rows, W = f2.shape
    return k5_call_bound_ms(code_f.shape[0], DC, rows,
                            2 * n_valid if n_valid else W)


KERNELS = [dict(where="gnss_dsp_tpu_torch.ops.acquire_coh",
                attr="corr_surface_coh_spec", name="k5", trace=TRACE,
                bound=bound)]


def read(ctx):
    return ctx.roofline("k5")
