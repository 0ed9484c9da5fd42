"""Unknown-code recovery: data-wiped samples summed into per-chip bins
while a known signal is tracked, as the reference captured the BeiDou
B2b memory codes (track-beidou-b2bi.py:46-53).

Counterpart: gnss_dsp_tpu/track/recover.py (`CodeRecovery`) and
ops/nco.py:96-110 (`accum_code_bins`, here ops/nco.accum_code_bins).

In tracking the bins ride the loop state (TrackState.acc_re / acc_im,
track/engine._recover): the engine adds each block's wiped samples,
times the sign of the prompt's I arm, at the prompt's chip index once
block > recover_after.  The reference runs recovery on its XLA
correlator only (driver.py:125-128), so the port runs it on the plain
scan (track/engine.track_scan_plain), on the card's tensors where the
chunk lies there: the reference's route, not a fallback, with no kernel.
The additions go in sample order (ops/nco.accum_rows), so the bins have
the same bits from run to run and on every device.

CodeRecovery is the stand-alone form: feed it wiped blocks, read the
recovered +-1 chips (the sign of the real bins).
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_dsp_tpu_torch.ops import nco


class CodeRecovery:
    """The reference's class and signature: the bins are made on the
    first update, on the device of its block, so that they lie where the
    data does (the card for the card's tensors)."""

    def __init__(self, code_length: int, warmup_blocks: int = 200):
        self.code_length = int(code_length)
        self.warmup = int(warmup_blocks)
        self.acc_re = self.acc_im = None
        self.blocks = 0

    def update(self, x_wiped: torch.Tensor, code_p: float, cf: float,
               p_prompt_re: float):
        """x_wiped: complex64 carrier-wiped block; code_p and cf (chips
        a sample) as in the tracking loop; the sign from the prompt's I
        arm (b2bi.py:47-51).  The first `warmup` blocks only count."""
        if self.acc_re is None:
            self.acc_re = torch.zeros(self.code_length,
                                      device=x_wiped.device)
            self.acc_im = torch.zeros_like(self.acc_re)
        self.blocks += 1
        if self.blocks <= self.warmup:
            return
        s = 1.0 if p_prompt_re > 0 else -1.0
        ar, ai = nco.accum_code_bins(x_wiped * s, code_p, cf,
                                     self.code_length)
        self.acc_re = self.acc_re + ar
        self.acc_im = self.acc_im + ai

    def _re(self) -> np.ndarray:
        if self.acc_re is None:
            return np.zeros(self.code_length, np.float32)
        return self.acc_re.cpu().numpy()

    def chips(self) -> np.ndarray:
        """Recovered +-1 chips (int8)."""
        return np.where(self._re() >= 0, 1, -1).astype(np.int8)

    def confidence(self) -> float:
        """Mean |bin| in units of its spread: a rough chip-decision SNR."""
        a = np.abs(self._re())
        return float(a.mean() / (a.std() + 1e-12))
