"""The tracking rows as text: the reference's row formats and RowText,
the track CLI's writer of a scan's rows in one go.

Counterpart: gnss_dsp_tpu/track/driver.py (`format_row_14` :704-711,
the 9-column rows of e.g. track-galileo-e1b.py:166-167) and the CLIs'
per-row print.

A RowText on a card passed as track_file's or track_receiver's `emit`
takes track/driver.emit_rows's bulk path (RowText.scan): the scan's rows
are turned into the CLI's exact text there (ops/track_rows, the kernel
csrc/track_rows.cu), read back as one buffer with the channels' final
counters, and written with one write a scan.  Any other emit takes the
rows a dict at a time, as does a RowText on another device or a scan
with a field past the fixed-point range; a RowText called as emit(k,
row) writes that row's line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gnss_dsp_tpu_torch.ops import track_rows
from gnss_dsp_tpu_torch.utils import profiling

# the host counters' bound for the int64 running sums of a scan
_COUNTER_MAX = 2 ** 62


def format_row_14(row: dict) -> str:
    """The reference 14-column text row (track-gps-l1.py:176-177)."""
    return "%d %f %f %f %f %f %f %f %f %d %f %d %f %d" % (
        row["block"], row["p_re"], row["p_im"], row["carrier_f"],
        row["code_f_offset"], row["phase_deg"], row["early"], row["prompt"],
        row["late"], row["code_cyc"], row["code_p"], row["carrier_cyc"],
        row["carrier_p"], row["samp"],
    )


def format_row_9(row: dict) -> str:
    """The reference 9-column row (e.g. track-galileo-e1b.py:166-167)."""
    return "%d %f %f %f %f %f %f %f %f" % (
        row["block"], row["p_re"], row["p_im"], row["carrier_f"],
        row["code_f_offset"], row["phase_deg"], row["early"], row["prompt"],
        row["late"],
    )


class RowText:
    """Rows written as the track CLI's text to sys.stdout (looked up at
    each write: contextlib.redirect_stdout swaps it).

    prefixes: each emitted channel's line prefix (str or bytes, ASCII);
    formats: each channel's row format, 14 columns or else 9; device:
    where the scans' rows are (a card: a scan formatted at once by the
    kernel, `bulk`; any other: a row at a time, through __call__)."""

    def __init__(self, prefixes, formats, device):
        self.prefixes = [p.encode("ascii") if isinstance(p, str) else bytes(p)
                         for p in prefixes]
        self.formats = [14 if f == 14 else 9 for f in formats]
        if len(self.formats) != len(self.prefixes):
            raise ValueError("RowText needs one prefix and format a channel")
        self.device = torch.device(device)
        self.bulk = self.device.type == "cuda"
        self._tables = None

    def write(self, text: str):
        sys.stdout.write(text)

    def __call__(self, k: int, row: dict):
        """Write channel k's row (a dict as emit_rows builds it)."""
        fmt = format_row_14 if self.formats[k] == 14 else format_row_9
        self.write(self.prefixes[k].decode("ascii") + fmt(row) + "\n")

    def _on_device(self):
        """(prefix bytes, their offsets, 14-column flags) on the device,
        built once."""
        if self._tables is None:
            off = np.cumsum([0] + [len(p) for p in self.prefixes])
            self._tables = (
                torch.tensor(list(b"".join(self.prefixes)),
                             dtype=torch.uint8).to(self.device),
                torch.tensor(off, dtype=torch.int32).to(self.device),
                torch.tensor([f == 14 for f in self.formats],
                             dtype=torch.int32).to(self.device))
        return self._tables

    def scan(self, channels, n_emit: int, rows_f, rows_i, nb: int):
        """Write the rows of a scan (emit_rows's arguments) in one go and
        leave each emitted channel's samp, code_cyc and carrier_cyc as the
        row-by-row path does.  Returns emit_rows's value, or None where
        the scan takes the row-by-row path (not `bulk`, a field past the
        fixed-point range, a counter past 2^62): nothing written or
        counted then.
        The kernel's launch and the read-back are the span
        `track.readback`; counter `track.rows.bulk`: the lines."""
        start = [[ch.samp, ch.code_cyc, ch.carrier_cyc]
                 for ch in channels[:n_emit]]
        if not self.bulk or any(abs(v) >= _COUNTER_MAX
                                for c in start for v in c):
            return None
        dev = self.device
        with profiling.span("track.readback"):
            prefix, off, wide = self._on_device()
            head, text = track_rows.rows_text(
                rows_f.to(dev), rows_i.to(dev), nb, n_emit, prefix,
                off[:n_emit + 1], wide[:n_emit],
                torch.tensor(start, dtype=torch.int64).reshape(n_emit, 3)
                .to(dev))
            head = head.cpu().numpy()
            if head[3]:
                return None
            data = text[:int(head[0])].cpu().numpy()
        final = head[track_rows.HEAD:].reshape(n_emit, 3).tolist()
        for ch, (samp, code_cyc, carrier_cyc) in zip(channels, final):
            ch.samp, ch.code_cyc, ch.carrier_cyc = samp, code_cyc, carrier_cyc
        if len(data):
            self.write(str(memoryview(data), "ascii"))
        profiling.count("track.rows.bulk", int(head[1]))
        return bool(head[2])
