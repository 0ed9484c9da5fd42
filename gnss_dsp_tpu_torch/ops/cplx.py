"""int8 and int4 I/Q ingest.

Counterpart: gnss_dsp_tpu/ops/cplx.py (`from_int8_iq` with `pad`,
`pack_int4_host` :61-78, `from_int4_iq` :80-96 with `_deint4_dev`
:40-58).  The JAX package kept complex values as split (re, im) float32
planes because its TPU backend had no complex dtype; here samples are
complex64 tensors and the rest of that module has no counterpart.

The raw interleaved int8 bytes travel to the device as they are (2 bytes
per sample) and are converted there; int8 -> float32 is exact.  The
opt-in 4-bit front end (GNSS_DSP_UPLOAD_INT4 in track/driver.track_file
and track/receiver.track_receiver) packs each sample into one byte on
the host and unpacks it on the device with elementwise torch operations,
as the reference does with XLA's (not a Pallas kernel there, so no CUDA
kernel here).
"""

from __future__ import annotations

import numpy as np
import torch


def from_int8_iq(raw, pad: int = 0, *, device) -> torch.Tensor:
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


_PACK4_LUT = None


def pack_int4_host(raw_int8: np.ndarray) -> np.ndarray:
    """Interleaved int8 I/Q -> one byte a sample, I in the high nibble
    and Q in the low, each v4 = clip(round(v / 8), -7, 7) as 4-bit two's
    complement: the classic coarse-quantisation front end (about 0.2-0.5
    dB of C/N0 at the synthetic captures' level), half the bytes of int8
    on the way to the device.  A 256-entry byte table, as the
    reference's."""
    global _PACK4_LUT
    if _PACK4_LUT is None:
        v = np.arange(256, dtype=np.uint8).view(np.int8).astype(np.int16)
        _PACK4_LUT = (np.clip((v + 4) >> 3, -7, 7) & 15).astype(np.uint8)
    nib = _PACK4_LUT[np.asarray(raw_int8).view(np.uint8)]
    return (nib[0::2] << 4 | nib[1::2]).astype(np.uint8)


def from_int4_iq(packed, pad: int = 0, scale: float = 8.0,
                 device="cpu") -> torch.Tensor:
    """Packed 4-bit I/Q (pack_int4_host) -> complex64 [n + pad] on
    `device`: one byte a sample uploaded, the nibbles sign-extended
    ((v ^ 8) - 8) and times `scale` (back to the int8 range) on the
    device, `pad` zero samples appended there."""
    if isinstance(packed, (bytes, bytearray, memoryview)):
        packed = np.frombuffer(packed, np.uint8)
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    if not packed.flags.writeable:
        packed = packed.copy()
    u = torch.from_numpy(packed).to(device).to(torch.int32)   # 1 B a sample
    i4 = (((u >> 4) & 15) ^ 8) - 8
    q4 = ((u & 15) ^ 8) - 8
    sc = float(np.float32(scale))
    f = torch.stack([i4.to(torch.float32) * sc, q4.to(torch.float32) * sc],
                    dim=1)
    if pad:
        f = torch.nn.functional.pad(f, (0, 0, 0, int(pad)))
    return torch.view_as_complex(f.contiguous())


def from_iq(raw, pad: int = 0, *, device, int4: bool = False):
    """(complex64 chunk on `device`, bytes uploaded): the int8 I/Q bytes
    `raw` through from_int8_iq, or with int4 packed on the host and
    through from_int4_iq."""
    if int4:
        packed = pack_int4_host(np.asarray(raw, np.int8))
        return from_int4_iq(packed, pad=pad, device=device), packed.nbytes
    return from_int8_iq(raw, pad=pad, device=device), len(raw)
