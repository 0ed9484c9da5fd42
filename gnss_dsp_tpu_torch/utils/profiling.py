"""Profiling and throughput counters.

Counterpart: gnss_dsp_tpu/utils/profiling.py.

- `device_sync(token)`: wait for the card's work; torch.cuda.synchronize
  on the device of `token` (any tensor, or a tuple or list whose first
  leaf is one), a no-op on the CPU.
- `trace(log_dir)`: torch.profiler around the block (CPU, and CUDA where
  there is a card), its Chrome trace written to log_dir/trace.json.
- `Counters`: throughput accounting (samples, search cells, blocks)
  against wall time, reported in the reference's one-line format.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


def _first_tensor(token):
    while isinstance(token, (tuple, list)):
        token = token[0]
    return token


def device_sync(token=None):
    """Return once the work before it on `token`'s device is done: a
    CUDA synchronize there (on the current card when token is None and
    there is one); nothing to wait for on the CPU."""
    t = _first_tensor(token)
    if t is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block; yields the profiler and writes
    log_dir/trace.json (open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class Counters:
    """Accumulate throughput metrics across engine calls."""
    t0: float = field(default_factory=time.perf_counter)
    samples: int = 0
    cells: int = 0
    blocks: int = 0

    def report(self) -> str:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        parts = [f"wall {dt:.3f}s"]
        if self.samples:
            parts.append(f"{self.samples/dt/1e6:.1f} Msamples/s")
        if self.cells:
            parts.append(f"{self.cells/dt/1e9:.2f} Gcells/s")
        if self.blocks:
            parts.append(f"{self.blocks/dt:.0f} blocks/s")
        return "  ".join(parts)
