"""int8 and int4 I/Q ingest.

Counterpart: gnss_dsp_tpu/ops/cplx.py (`from_int8_iq` with `pad`,
`pack_int4_host` :61-78, `from_int4_iq` :80-96 with `_deint4_dev`
:40-58).  The JAX package kept complex values as split (re, im) float32
planes because its TPU backend had no complex dtype; here samples are
complex64 tensors and the rest of that module has no counterpart.

The raw interleaved int8 bytes travel to the device as they are (2 bytes
per sample) and are converted there; int8 -> float32 is exact.  The
opt-in 4-bit front end (GNSS_DSP_UPLOAD_INT4 in the tracking loops'
chunks, track/driver._Chunks) packs each sample into one byte on
the host and unpacks it on the device with elementwise torch operations,
as the reference does with XLA's (not a Pallas kernel there, so no CUDA
kernel here).

Each upload is the span `upload` (on the device's stream too) and counts
its bytes under `h2d.bytes` (utils/profiling).  The streaming tracking
loops upload each chunk's new parts with from_iq: straight from the
prefetch reader's staging slots into a slice of the chunk, with no host
copy, an asynchronous copy where a slot is pinned (counter
`h2d.pinned_bytes`), converted in place on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_dsp_tpu_torch.utils import profiling


def from_int8_iq(raw, pad: int = 0, *, device) -> torch.Tensor:
    """Interleaved int8 I/Q (bytes or int8 array) -> complex64 [n + pad]
    on `device`, with `pad` zero samples appended on the device."""
    with profiling.span("upload", device=device):
        if isinstance(raw, (bytes, bytearray, memoryview)):
            raw = np.frombuffer(raw, np.int8)
        raw = np.ascontiguousarray(raw, dtype=np.int8)
        if not raw.flags.writeable:   # torch.from_numpy wants writable memory
            raw = raw.copy()
        profiling.count("h2d.bytes", raw.nbytes)
        d = torch.from_numpy(raw).to(device)             # [2n] int8 upload
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
    with profiling.span("upload", device=device):
        if isinstance(packed, (bytes, bytearray, memoryview)):
            packed = np.frombuffer(packed, np.uint8)
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        if not packed.flags.writeable:
            packed = packed.copy()
        profiling.count("h2d.bytes", packed.nbytes)
        f = _deint4(torch.from_numpy(packed).to(device), scale)  # 1 B/sample
        if pad:
            f = torch.nn.functional.pad(f, (0, 0, 0, int(pad)))
        return torch.view_as_complex(f.contiguous())


def _deint4(u: torch.Tensor, scale: float = 8.0) -> torch.Tensor:
    """Packed 4-bit I/Q bytes on the device -> float32 [n, 2]: the
    nibbles sign-extended ((v ^ 8) - 8) and times `scale`."""
    u = u.to(torch.int32)
    i4 = (((u >> 4) & 15) ^ 8) - 8
    q4 = ((u & 15) ^ 8) - 8
    sc = float(np.float32(scale))
    return torch.stack([i4.to(torch.float32) * sc,
                        q4.to(torch.float32) * sc], dim=1)


def from_iq(parts, *, into: torch.Tensor, int4: bool = False) -> int:
    """Write the int8 I/Q parts (numpy views, such as the prefetch
    reader's slot views), in order, into the complex64 slice `into` on
    its device; the bytes uploaded.  On a card the parts (packed to 4
    bits with int4, part by part) go up into one staging buffer by
    non_blocking copies, asynchronous from pinned memory, and are
    converted into place there; on the CPU each part is converted into
    place from where it lies."""
    dev = into.device
    with profiling.span("upload", device=dev):
        if int4:
            parts = [pack_int4_host(p) for p in parts]
        src = [torch.from_numpy(p) for p in parts]
        nbytes = sum(s.numel() for s in src)
        pinned = 0
        if dev.type == "cuda":
            pinned = sum(s.numel() for s in src if s.is_pinned())
            staged = torch.empty(nbytes, dtype=src[0].dtype, device=dev)
            o = 0
            for s in src:
                staged[o:o + s.numel()].copy_(s, non_blocking=True)
                o += s.numel()
            src = [staged]
        profiling.count("h2d.bytes", nbytes)
        profiling.count("h2d.pinned_bytes", pinned)
        o = 0
        for s in src:
            f = _deint4(s) if int4 else s.view(-1, 2)
            torch.view_as_real(into[o:o + f.shape[0]]).copy_(f)
            o += f.shape[0]
        if o != into.shape[0]:
            raise ValueError(f"{o} samples uploaded into a slice of "
                             f"{into.shape[0]}")
    return nbytes
