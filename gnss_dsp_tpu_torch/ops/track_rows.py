"""A tracking scan's rows as the track CLI's text, in bulk on the card.

Kernel: csrc/track_rows.cu, for CUDA tensors only (track/rows.RowText
formats a scan a row at a time on any other device).  Replaces no TPU
kernel: the reference formats a row at a time on the host
(gnss_dsp_tpu/track/driver.py:505-536 and format_row_14 :704-711).  The
kernel makes the bytes that `prefix + format_row_14(row) + "\\n"` (or
format_row_9) gives for every row emit_rows would emit, in its order
(block-major, then channel; no line where n == 0, none for the clones
from n_emit on), with the running host counters samp, code_cyc and
carrier_cyc in int64.

%f of a float32 x is exact in fixed point: (double)x * 1e6 is exact (a
24-bit significand times 2^6 * 15625, 15625 < 2^14), so q = rint(|x| *
1e6), ties to even, is Python's correctly rounded %f: `-` where the sign
bit is set and x is not NaN, q // 10^6, `.`, six digits of q % 10^6;
`nan`, `inf`, `-inf` for the others.  A row with a finite field of |x|
>= FIXED_MAX (past int64 in fixed point), or a block that is not finite
or past it, flags the scan: no text, and the caller formats it a row at
a time.  LAUNCHES counts kernel calls.
"""

from __future__ import annotations

import torch

from gnss_dsp_tpu_torch.ops import _build

HEAD = 4                  # text bytes, lines, any row ran, overflow
FIXED_MAX = 9.2e12        # rint(|x| * 1e6) fits int64 below it
# the longest line without its prefix: a block of 14 characters, ten %f
# of 21, three int64 of 20, 13 spaces and the newline
LINE_MAX = 298
LAUNCHES = 0


def rows_text(rows_f, rows_i, nb: int, n_emit: int, prefix, prefix_off,
              wide, counters):
    """(head int64 [HEAD + 3 n_emit], text uint8 [>= head[0]]) on the
    rows' device.  head: [0] the text's bytes, [1] its lines, [2] 1 if any
    channel (clones too) ran a block, [3] 1 if the scan is flagged (a
    field past FIXED_MAX; no text, [0] and [1] 0), then each emitted
    channel's samp, code_cyc, carrier_cyc after the scan.

    rows_f f32 [B, C, 11] and rows_i i32 [B, C, 3] as track_scan returns
    them, nb <= B blocks of them; channels from n_emit on are clones;
    prefix uint8 [P] the n_emit line prefixes back to back, prefix_off
    int32 [n_emit + 1] where each starts; wide int32 [n_emit], 1 for 14
    columns, 0 for 9; counters int64 [n_emit, 3], each channel's samp,
    code_cyc, carrier_cyc before the scan.  All on one CUDA device."""
    global LAUNCHES
    B, C = rows_f.shape[:2]
    E = int(n_emit)
    if (rows_f.dtype != torch.float32 or rows_i.dtype != torch.int32
            or tuple(rows_f.shape) != (B, C, 11)
            or tuple(rows_i.shape) != (B, C, 3) or not 0 <= nb <= B
            or not 0 <= E <= C or C < 1):
        raise ValueError(f"rows_text: rows_f f32 [B, C, 11], rows_i i32 "
                         f"[B, C, 3], 0 <= nb <= B, 0 <= n_emit <= C; got "
                         f"{tuple(rows_f.shape)} {rows_f.dtype}, "
                         f"{tuple(rows_i.shape)} {rows_i.dtype}, {nb}, {E}")
    if (prefix.dtype != torch.uint8 or tuple(prefix_off.shape) != (E + 1,)
            or tuple(wide.shape) != (E,)
            or tuple(counters.shape) != (E, 3)
            or counters.dtype != torch.int64):
        raise ValueError("rows_text: prefix uint8, prefix_off [n_emit + 1], "
                         "wide [n_emit], counters int64 [n_emit, 3]")
    dev = rows_f.device
    for t in (rows_i, prefix, prefix_off, wide, counters):
        if t.device != dev:
            raise ValueError("all rows_text tensors must share a device")
    if dev.type != "cuda":
        raise ValueError(f"rows_text: CUDA tensors only, got {dev}")
    lib = _build.load()
    rf, ri = rows_f.contiguous(), rows_i.contiguous()
    pre = prefix if prefix.numel() else torch.zeros(1, dtype=torch.uint8,
                                                    device=dev)
    off = prefix_off.to(torch.int32).contiguous()
    wd = wide.to(torch.int32).contiguous()
    c0 = counters.contiguous()
    R = nb * C
    # at most one line a channel a block, each within LINE_MAX and its
    # own prefix
    cap = nb * (E * LINE_MAX + int(prefix.numel()))
    run = torch.empty(max(nb * E * 3, 1), dtype=torch.int64, device=dev)
    lens = torch.empty(max(R, 1), dtype=torch.int32, device=dev)
    offs = torch.empty(max(R, 1), dtype=torch.int64, device=dev)
    head = torch.empty(HEAD + 3 * E, dtype=torch.int64, device=dev)
    text = torch.empty(max(cap, 1), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.track_rows(
            rf.data_ptr(), ri.data_ptr(), int(nb), int(C), E,
            pre.data_ptr(), off.data_ptr(), wd.data_ptr(), c0.data_ptr(),
            run.data_ptr(), lens.data_ptr(), offs.data_ptr(),
            head.data_ptr(), text.data_ptr(), cap, stream)
    _build.check(err, "track_rows launch")
    LAUNCHES += 1
    return head, text

