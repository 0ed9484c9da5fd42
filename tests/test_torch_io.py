"""The port's host sample ingest (gnss_dsp_tpu_torch/utils/io.py) against
the JAX package's (gnss_dsp_tpu/utils/io.py, whose deinterleave is
utils/native's, built or its numpy fallback): bit for bit on random
int8, short reads included, and the card upload route
(ops/cplx.from_int8_iq) bit-equal to the host conversion."""

import io

import numpy as np
import pytest
import torch

from gnss_dsp_tpu_torch.ops import cplx
from gnss_dsp_tpu_torch.utils import io as tio


def _raw(n, seed):
    return np.random.default_rng(seed).integers(
        -128, 128, size=2 * n, dtype=np.int64).astype(np.int8).tobytes()


@pytest.mark.parametrize("n,ask", [(1000, 1000), (1000, 400), (999, 1000),
                                   (0, 5)])
def test_get_samples_complex_matches_reference(n, ask):
    """A full read gives the reference's complex64 bits; a short read
    (EOF) gives None, as the reference's."""
    from gnss_dsp_tpu.utils import io as jio

    raw = _raw(n, n + ask)
    got = tio.get_samples_complex(io.BytesIO(raw), ask)
    want = jio.get_samples_complex(io.BytesIO(raw), ask)
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


@pytest.mark.parametrize("as_array", [False, True])
def test_bytes_to_split_and_complex_match_reference(as_array):
    from gnss_dsp_tpu.utils import io as jio

    raw = _raw(4097, 4)
    arg = np.frombuffer(raw, np.int8) if as_array else raw
    re, im = tio.bytes_to_split(arg)
    jre, jim = jio.bytes_to_split(arg)
    assert re.dtype == np.float32 and re.flags.c_contiguous
    np.testing.assert_array_equal(re, jre)
    np.testing.assert_array_equal(im, jim)
    np.testing.assert_array_equal(tio.bytes_to_complex(arg),
                                  jio.bytes_to_complex(arg))


def test_sample_stream_matches_reference():
    """Fixed blocks, the final partial block dropped; read() as
    get_samples_complex."""
    from gnss_dsp_tpu.utils import io as jio

    raw = _raw(1000, 5)
    got = list(tio.SampleStream(io.BytesIO(raw), 300))
    want = list(jio.SampleStream(io.BytesIO(raw), 300))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    s = tio.SampleStream(io.BytesIO(raw), 300)
    np.testing.assert_array_equal(s.read(999),
                                  jio.bytes_to_complex(raw[:1998]))
    assert s.read(2) is None


def test_card_upload_route_equals_the_host_conversion():
    """ops/cplx.from_int8_iq (the CLIs' upload: raw int8, converted on the
    device) gives the host conversion's bits, with its zero pad."""
    raw = _raw(1000, 6)
    dev = cplx.from_int8_iq(raw, pad=24, device="cpu")
    assert dev.shape[0] == 1024
    host = torch.from_numpy(tio.bytes_to_complex(raw))
    assert torch.equal(dev[:1000], host)
    assert float(dev[1000:].abs().max()) == 0.0
