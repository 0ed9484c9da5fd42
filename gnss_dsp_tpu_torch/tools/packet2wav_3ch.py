#!/usr/bin/env python3
"""Band demuxer of the three-band sky container.

Counterpart: tools/packet2wav_3ch of the repository root, the stand-in
for the reference workload's external packet2wav_3ch (acquire-all.sh:9).
Reads the container from stdin (1 ms per-band frames of int8 I/Q at
69.984 MHz, tools/synth_sky.py) and streams band N (1..3) to stdout; a
trailing partial frame is dropped.

    <capture python gnss_dsp_tpu_torch/tools/packet2wav_3ch.py N | ...
"""

import sys

FRAME_BYTES = 2 * int(69.984e6 // 1000)     # one band, one 1 ms frame


def demux(src, dst, band: int):
    """Copy band `band`'s frames from the binary stream src to dst."""
    if band not in (1, 2, 3):
        raise ValueError(f"band {band}: want 1, 2 or 3")
    try:
        while True:
            frame = src.read(3 * FRAME_BYTES)
            if len(frame) < 3 * FRAME_BYTES:
                break
            dst.write(frame[(band - 1) * FRAME_BYTES: band * FRAME_BYTES])
    except BrokenPipeError:     # downstream read all it wanted
        pass


if __name__ == "__main__":
    demux(sys.stdin.buffer, sys.stdout.buffer, int(sys.argv[1]))
