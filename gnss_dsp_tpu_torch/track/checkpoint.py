"""Checkpoint and exact resume of the tracking state.

Counterpart: gnss_dsp_tpu/track/checkpoint.py (`save`, `load`).  A
checkpoint is one npz in the reference's format: every TrackState field
under its own name (coffset_p as uint32), the per-channel host counters
host_samp, host_code_cyc, host_carrier_cyc and host_prn (int64), and
meta_json, a JSON dict as uint8 bytes (track_file writes abs_buf0, the
stream sample at the chunk's start, and total_blocks).  So a checkpoint
the JAX package wrote loads here, and one written here loads there.
track/driver.track_file writes one after every chunk, to a `.tmp` file
renamed over the old one, and resumes from one bit for bit.
"""

from __future__ import annotations

import json

import numpy as np

from gnss_dsp_tpu_torch import interop
from gnss_dsp_tpu_torch.device import resolve_device


def save(path, state, channels=None, meta: dict | None = None):
    """Write state (and the channels' host counters) to one npz; `path`
    a file name or a binary file object."""
    arrays = interop.state_to_numpy(state)
    if channels is not None:
        arrays["host_samp"] = np.array([c.samp for c in channels], np.int64)
        arrays["host_code_cyc"] = np.array([c.code_cyc for c in channels],
                                           np.int64)
        arrays["host_carrier_cyc"] = np.array(
            [c.carrier_cyc for c in channels], np.int64)
        arrays["host_prn"] = np.array([c.prn for c in channels], np.int64)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                        dtype=np.uint8)
    np.savez(path, **arrays)


def load(path, device="cuda"):
    """(TrackState on `device`, the card unless the caller asks for the
    CPU; host counters {name: int64 [C]}; meta dict) of a checkpoint,
    the port's or the JAX package's."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    state = interop.state_from_numpy(arrays, resolve_device(device))
    host = {k[5:]: v for k, v in arrays.items() if k.startswith("host_")}
    meta = json.loads(bytes(arrays["meta_json"]).decode() or "{}")
    return state, host, meta
