"""Signal descriptors: the single source of truth consumed by both engines.

The reference spreads this information across 65 CLI scripts; the values
here are extracted per SURVEY.md §2.3 (code construction) and §2.4
(per-script acquisition/tracking parameters), with file:line citations in
each entry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass(frozen=True)
class Signal:
    name: str                      # registry key, e.g. "gps-l1"
    constellation: str
    chip_rate: float
    code_length: int
    # (prns) -> int8 [len(prns), code_length] in {-1,+1}
    code_table: Callable[[tuple], np.ndarray]
    prn_all: tuple                 # valid PRN/channel numbers
    prn_default: str               # default CLI range string, e.g. "1-32"
    secondary: Optional[Callable[[int], np.ndarray]] = None  # prn -> ±1 chips
    subcarrier: str = "none"       # none|boc11|tmboc|cboc|rz_even|rz_odd

    # --- acquisition engine parameters (SURVEY §2.4 acquisition table) ---
    acq_fs: float = 4.096e6        # internal resample rate
    acq_coherent_ms: float = 1.0   # coherent integration per block
    acq_pad2: bool = False         # zero-pad FFT to 2n
    acq_boc_ref: bool = False      # multiply FFT reference by BOC(1,1)
    acq_sliding: bool = False      # 2-block sliding windows (Galileo E1)
    acq_lowpass_hz: float = 1.5e6  # front-end FIR cutoff
    acq_ms_default: int = 80       # --time default
    acq_metric: str = "peak"       # "peak_mean" only for gps-l1/xona (acquire-gps-l1.py:35)
    acq_blocks_override: int = 0   # b2ad quirk: hardcoded 80 blocks
    doppler_default: tuple = (-7000.0, 7000.0, 200.0)
    fdma_hz: float = 0.0           # doppler grid offset per channel (GLONASS)

    # --- assisted serial search (L2CL, GLONASS P handover) ---
    acq_serial: int = 0            # hypothesis count (75 / 1000); 0 = FFT search
    acq_serial_stride: float = 0.0 # chips between hypotheses (10230 / 5110)
    acq_serial_scale: float = 1.0  # parent code-phase -> chips factor (1 / 10)
    acq_serial_coh_ms: float = 0.0 # coherent block length (20 / 4 ms)

    # --- tracking engine parameters (SURVEY §2.4 tracking table) ---
    carrier_ratio: float = 1540.0  # code NCO doppler-aid divisor
    el_spacing: float = 0.05       # early/late offset, chips
    track_mode_initial: str = "FLL_WIDE"
    pll_k1: float = 0.1
    pll_k2: float = 3.5
    # unknown-code recovery: accumulate data-wiped samples into per-chip
    # bins after 200 blocks and dump track-chips.dat at EOF — on by
    # default only where the reference does it (track-beidou-b2bi.py:47-53)
    recover_default: bool = False
    row_format: int = 9            # reference text row: 9 or 14 columns
    # GLONASS FDMA: carrier_ratio is per-channel,
    # (rf0 + step*chan) / code_mhz  (track-glonass-l1.py:36-39)
    fdma_rf0_mhz: float = 0.0
    fdma_step_mhz: float = 0.0
    fdma_code_mhz: float = 0.0

    @property
    def code_period_ms(self) -> float:
        return 1000.0 * self.code_length / self.chip_rate

    @property
    def sub_blocks(self) -> int:
        """Correlator subdivisions per code period — the reference tracks
        in ~1 ms sub-blocks whenever the code period exceeds 1 ms
        (track-galileo-e1b.py:164, track-gps-l2cm.py:164)."""
        return max(int(round(self.code_period_ms)), 1)

    def track_carrier_ratio(self, chan: int = 0) -> float:
        if self.fdma_code_mhz:
            return (self.fdma_rf0_mhz + self.fdma_step_mhz * chan) / self.fdma_code_mhz
        return self.carrier_ratio

    def prns(self, spec: str | None = None) -> list[int]:
        from gnss_dsp_tpu_torch.utils.ranges import parse_list_ranges

        sep = ":" if (self.fdma_hz != 0.0) else "-"
        return parse_list_ranges(spec or self.prn_default, sep=sep)


REGISTRY: dict[str, Signal] = {}


def register(sig: Signal) -> Signal:
    REGISTRY[sig.name] = sig
    return sig


def get_signal(name: str) -> Signal:
    # populate lazily so importing the package stays cheap
    import gnss_dsp_tpu_torch.models.catalog  # noqa: F401

    return REGISTRY[name]


def all_signals() -> dict[str, Signal]:
    import gnss_dsp_tpu_torch.models.catalog  # noqa: F401

    return dict(REGISTRY)
