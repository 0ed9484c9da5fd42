"""Carry numbers between the JAX package and the port, as numpy.

The tests use these so that both packages start from identical inputs:

  params_from_jax(p)           JAX TrackParams -> port TrackParams, with
                               the route (fused_scan, pallas_v2) and the
                               coherent span (coh_blocks)
  state_from_numpy(d, device)  {field: array} (JAX TrackState leaves,
                               the recovery bins acc_re/acc_im and cacc
                               [C, 6] among them; a JAX checkpoint's
                               arrays too) -> port TrackState;
                               coffset_p uint32 -> int64
  state_to_numpy(state)        port TrackState -> {field: array};
                               coffset_p int64 -> uint32
  code_ffts_from_split(re, im, plan=None)
                               split code (or data) spectra -> natural
                               order complex64; with a v2 kernel plan
                               (n1, n2) or ("v2", n1, n2) it undoes
                               pallas_acquire2.permute_host2

Nothing here imports jax: JAX values arrive as numpy arrays or as
NamedTuples of python scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_dsp_tpu_torch.track.engine import TrackParams, TrackState

_UINT32_FIELDS = ("coffset_p",)
_DTYPES = {"ptr": np.int32, "block": np.int32, "n_full": np.int32,
           "sub_j": np.int32, "stalled": bool, "coffset_p": np.int64}


def params_from_jax(p) -> TrackParams:
    """A JAX TrackParams (any NamedTuple with those fields) -> the port's.
    The route fields fused_scan (K2) and pallas_v2 (K3, else K4), and
    coh_blocks and recover_after, carry across; the TPU layout fields
    (use_pallas, pallas_tiles, pallas_w, pallas_stream) are dropped."""
    src = p._asdict()
    return TrackParams(**{k: src[k] for k in TrackParams._fields})


def state_from_numpy(d, device) -> TrackState:
    """{field: array} -> TrackState.  Accepts a JAX TrackState or the
    arrays of a checkpoint (np.load) too; where the recovery bins
    acc_re/acc_im are missing they are [C, 1] zeros (recovery off)."""
    if hasattr(d, "_asdict"):
        d = d._asdict()
    out = {}
    for k in TrackState._fields:
        if k in ("acc_re", "acc_im") and k not in d:
            a = np.zeros((np.asarray(d["ptr"]).shape[0], 1), np.float32)
        else:
            a = np.asarray(d[k])
        dt = _DTYPES.get(k, np.float32)
        if k in _UINT32_FIELDS:
            a = a.astype(np.uint32).astype(np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(a.astype(dt))).to(device)
    return TrackState(**out)


def state_to_numpy(state: TrackState) -> dict:
    out = {}
    for k in TrackState._fields:
        a = getattr(state, k).detach().cpu().numpy()
        if k in _UINT32_FIELDS:
            a = (a & 0xFFFFFFFF).astype(np.uint32)
        out[k] = a
    return out


def code_ffts_from_split(re, im, plan=None) -> torch.Tensor:
    """Split spectra [..., W] -> complex64 [..., W] in natural order."""
    re = np.asarray(re, np.float32)
    im = np.asarray(im, np.float32)
    c = (re + 1j * im.astype(np.complex64)).astype(np.complex64)
    if plan is not None:
        n1, n2 = plan[-2:]
        W = c.shape[-1]
        if n1 * n2 != W:
            raise ValueError(f"plan {plan} does not split W={W}")
        # permuted p = k1*n2 + k2 holds natural k2*n1 + k1
        c = np.ascontiguousarray(
            c.reshape(c.shape[:-1] + (n1, n2)).swapaxes(-1, -2)
        ).reshape(c.shape[:-1] + (W,))
    return torch.from_numpy(np.ascontiguousarray(c))
