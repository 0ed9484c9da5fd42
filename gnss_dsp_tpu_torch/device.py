"""Device selection.

There is no global default device in this package: every entry point
takes `device` and passes it on.  resolve_device refuses to hand out a
CUDA device that does not exist, so `--device cuda` on a machine without
a card fails loudly instead of running on the CPU.

GNSS_DSP_NO_PALLAS, the reference's switch to its XLA engines, is
honoured on the CPU only (the plain versions, acquire/plan's "xla"
route): on a card the port runs its kernels and nothing else, so every
entry point given a card refuses the switch (refuse_no_pallas).

GNSS_DSP_CPU, the reference's pin of its CLIs to the CPU, moves the
default of the port's CLIs (default_device): set, they run the plain
versions on the CPU and say so on stderr (pop_device_arg); an explicit
--device wins over it.  Library entry points take their device from the
caller and do not read it.
"""

from __future__ import annotations

import os
import sys

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


def default_device() -> str:
    """The CLIs' device when the line names none: "cpu" while GNSS_DSP_CPU
    is set (non-empty, as the reference reads it), else "cuda"."""
    return "cpu" if os.environ.get("GNSS_DSP_CPU") else "cuda"


def pop_device_arg(argv, what: str):
    """Take `--device NAME` / `--device=NAME` out of a CLI argv wherever it
    stands (the CLIs stop option parsing at the first positional, so that
    a negative carrier offset reads as a number).  Returns (name, rest).
    Without --device the name is default_device(); when that is the CPU
    because GNSS_DSP_CPU is set, one line on stderr says so, naming the
    CLI `what`."""
    argv = list(argv)
    name = None
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
    if name is None:
        name = default_device()
        if name == "cpu":
            print(f"{what}: GNSS_DSP_CPU is set: running on the CPU (the "
                  "plain versions); --device cuda overrides it",
                  file=sys.stderr)
    return name, out
