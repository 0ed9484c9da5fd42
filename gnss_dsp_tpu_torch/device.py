"""Device selection.

There is no global default device in this package: every entry point
takes `device` and passes it on.  resolve_device refuses to hand out a
CUDA device that does not exist, so `--device cuda` on a machine without
a card fails loudly instead of running on the CPU.
"""

from __future__ import annotations

import os

import torch

# The reference's environment switches that the port does not honour yet,
# and what each does there.  An entry point that one of them would move
# refuses to run while it is set (refuse_switches): it never runs a route
# the caller asked to leave.
SWITCHES = {
    "GNSS_DSP_NO_PALLAS": "sends acquisition and tracking to the XLA "
                          "engine (acquire/engine.py:307, acquire/"
                          "coherent.py:356, track/driver.py:112)",
    "GNSS_DSP_NO_V2P": "sends the pad2 signals to the v1 route at the "
                       "unpadded 2n window (acquire/engine.py:318)",
}
# GNSS_DSP_UPLOAD_INT4 (the 4-bit front end) is honoured: track_file and
# track_receiver quantise each chunk to 4 bits before the upload, as the
# reference's do (ops/cplx.from_int4_iq).


def refuse_switches(what: str, names=tuple(SWITCHES)):
    """Raise NotImplementedError naming the first of the switches `names`
    that is set (non-empty, as the reference reads them)."""
    for name in names:
        if os.environ.get(name):
            raise NotImplementedError(
                f"{what}: {name} is set; the reference then {SWITCHES[name]}, "
                f"which the port does not do yet")


def resolve_device(name="cuda") -> torch.device:
    """`name` ("cuda", "cuda:1", "cpu" or a torch.device) -> torch.device.

    On a CUDA device this also turns TF32 off for matmul and cuDNN: a
    float32 conv1d otherwise runs in TF32 (about 1e-3 relative error in
    the 161-tap front-end filter, enough to move acquisition peaks)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def pop_device_arg(argv, default="cuda"):
    """Take `--device NAME` / `--device=NAME` out of a CLI argv wherever it
    stands (the CLIs stop option parsing at the first positional, so that
    a negative carrier offset reads as a number).  Returns (name, rest)."""
    argv = list(argv)
    name = default
    out = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device needs a value")
            name = argv[i + 1]
            i += 2
            continue
        if a.startswith("--device="):
            name = a.split("=", 1)[1]
        else:
            out.append(a)
        i += 1
    return name, out
