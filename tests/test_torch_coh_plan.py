"""The port's coherent route (acquire/plan.py) against the JAX package's
own router, acquire/coherent.py::_coh_fast_plan, with its Pallas kernels
enabled in interpret mode: (mode, window, data_window, n_valid) equal for
every catalog signal with an FFT search, m_coh in {4, 8, 10, 20, N} and
P in {1, 32}; and every route the port's kernels take on the card.  Pure
host code."""

import pytest

from gnss_dsp_tpu.models.signal import all_signals

SIGNALS = sorted(name for name, sig in all_signals().items()
                 if not sig.acq_serial)


@pytest.mark.parametrize("P", [1, 32])
@pytest.mark.parametrize("m_coh", [4, 8, 10, 20, "N"])
@pytest.mark.parametrize("name", SIGNALS)
def test_coh_plan_matches_jax_router(name, m_coh, P, monkeypatch):
    monkeypatch.setenv("GNSS_DSP_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("GNSS_DSP_NO_PALLAS", raising=False)
    from gnss_dsp_tpu.acquire.coherent import _coh_fast_plan
    from gnss_dsp_tpu_torch.acquire.plan import coh_plan

    sig = all_signals()[name]
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    N = (len(sig.secondary(sig.prns()[0])) if sig.secondary is not None
         else 1)
    m = N if m_coh == "N" else m_coh
    want = _coh_fast_plan(sig, n, m, N, P, m)
    got = coh_plan(sig, n, m, N)
    assert got == (None if want is None else tuple(want[:4]))


@pytest.mark.parametrize("name", SIGNALS)
def test_every_catalog_route_has_its_kernel(name):
    """With m_coh the overlay length N and 2: the router sends K6
    ("blk") only windows of at most 16384, which K6's check admits, and
    K5's window check (ops/acquire_coh.spec_core_plan, the card's own
    plan) admits every window it sends to "spec".  Host code, no card."""
    from gnss_dsp_tpu_torch.acquire.plan import coh_plan
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops.acquire2 import check_w
    from gnss_dsp_tpu_torch.ops.acquire_coh import spec_core_plan

    sig = get_signal(name)
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    N = (len(sig.secondary(sig.prns()[0])) if sig.secondary is not None
         else 1)
    for m in (N, 2):
        plan = coh_plan(sig, n, m, N)
        if plan is None:
            continue
        mode, W = plan[:2]
        if mode == "blk":
            assert W <= 16384
            check_w(W, "K6")
        else:
            core, n1, n2, C = spec_core_plan(W)
            assert n1 * n2 == W and 1 <= C <= 16
