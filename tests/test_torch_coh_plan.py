"""The port's coherent route (acquire/plan.py) against the JAX package's
own router, acquire/coherent.py::_coh_fast_plan, with its Pallas kernels
enabled in interpret mode: (mode, window, data_window, n_valid) equal for
every catalog signal with an FFT search, m_coh in {4, 8, 10, 20, N} and
P in {1, 32}.  Pure host code."""

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
