"""Device selection.

There is no global default device in this package: every entry point
takes `device` and passes it on.  resolve_device refuses to hand out a
CUDA device that does not exist, so `--device cuda` on a machine without
a card fails loudly instead of running on the CPU.

GNSS_DSP_NO_PALLAS, the reference's switch to its XLA engines, is
honoured on the CPU only (the plain versions, acquire/plan's "xla"
route): on a card the port runs its kernels and nothing else, so every
entry point given a card refuses the switch (refuse_no_pallas).
"""

from __future__ import annotations

import os

import torch


def refuse_no_pallas(what: str, *devices) -> None:
    """Raise RuntimeError while GNSS_DSP_NO_PALLAS is set (non-empty, as
    the reference reads it) and any of `devices` is not the CPU."""
    if os.environ.get("GNSS_DSP_NO_PALLAS") and any(
            torch.device(d).type != "cpu" for d in devices):
        raise RuntimeError(
            f"{what}: GNSS_DSP_NO_PALLAS is set, which sends the reference "
            "to its XLA engines; on a card the port runs only its kernels. "
            "Unset it, or run on the CPU (--device cpu) for the plain "
            "versions")


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
