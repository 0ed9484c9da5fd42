"""int8 I/Q ingest.

Counterpart: gnss_dsp_tpu/ops/cplx.py (`from_int8_iq` with `pad`).  The
JAX package kept complex values as split (re, im) float32 planes because
its TPU backend had no complex dtype; here samples are complex64 tensors
and the rest of that module has no counterpart.

The raw interleaved int8 bytes travel to the device as they are (2 bytes
per sample) and are converted there; int8 -> float32 is exact.
"""

from __future__ import annotations

import numpy as np
import torch


def from_int8_iq(raw, pad: int = 0, device="cpu") -> torch.Tensor:
    """Interleaved int8 I/Q (bytes or int8 array) -> complex64 [n + pad]
    on `device`, with `pad` zero samples appended on the device."""
    if isinstance(raw, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(raw, np.int8)
    raw = np.ascontiguousarray(raw, dtype=np.int8)
    if not raw.flags.writeable:       # torch.from_numpy wants writable memory
        raw = raw.copy()
    d = torch.from_numpy(raw).to(device)                 # [2n] int8 upload
    f = d.view(-1, 2).to(torch.float32)
    if pad:
        f = torch.nn.functional.pad(f, (0, 0, 0, int(pad)))
    return torch.view_as_complex(f.contiguous())
