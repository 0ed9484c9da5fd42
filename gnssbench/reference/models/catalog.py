# Frozen copy of gnss_dsp_tpu_torch/models/catalog.py at commit 196026d.
# Changed: imports point at gnssbench.reference.models; GPS L1C, GPS P and
# Xona, which no cell or test of the benchmark uses, are left out.
"""The signal catalog: one entry per reference signal module/script pair
(SURVEY.md §2.3 code constructions, §2.4 per-script parameters).

Each entry cites the reference acquire/track scripts its numbers come
from.  Internal sample rates, FIR cutoffs, doppler grids, coherent
lengths, FFT padding, carrier-aiding ratios and E/L spacings were
extracted script by script (see SURVEY.md §2.4 tables).
"""

from __future__ import annotations

import numpy as np

from gnssbench.reference.models.signal import Signal, register
from gnssbench.reference.models.codes import (
    beidou, galileo, glonass, gps_ca, gps_l2c, gps_l5,
)


def _const(arr):
    return lambda prn: arr


# =================================================================== GPS

# GPS L1 C/A — acquire-gps-l1.py (4.096 MHz, 1 ms, no pad, peak/mean,
# +-7k/200, 1.5 MHz FIR), track-gps-l1.py (ratio 1540, EL 0.05, 14-col).
register(Signal(
    name="gps-l1", constellation="gps",
    chip_rate=gps_ca.chip_rate, code_length=gps_ca.code_length,
    code_table=gps_ca.code_table, prn_all=gps_ca.PRNS, prn_default="1-32",
    acq_fs=4.096e6, acq_coherent_ms=1.0, acq_pad2=False,
    acq_lowpass_hz=1.5e6, acq_metric="peak_mean",
    doppler_default=(-7000.0, 7000.0, 200.0),
    carrier_ratio=1540.0, el_spacing=0.05, row_format=14,
))

# GPS L2CM — acquire-gps-l2cm.py (4.096 MHz, 20 ms coherent, 2n pad,
# sliding, +-7k/20), track-gps-l2cm.py (ratio 2400, EL 0.5, RZ even).
register(Signal(
    name="gps-l2cm", constellation="gps",
    chip_rate=gps_l2c.chip_rate, code_length=gps_l2c.cm_code_length,
    code_table=gps_l2c.cm_table, prn_all=gps_l2c.prns_all(),
    prn_default="1-32", subcarrier="rz_even",
    acq_fs=4.096e6, acq_coherent_ms=20.0, acq_pad2=True,
    acq_lowpass_hz=1.5e6, doppler_default=(-7000.0, 7000.0, 20.0),
    carrier_ratio=2400.0, el_spacing=0.5,
))

# GPS L2CL — acquire-gps-l2cl.py (assisted serial search: 75 hypotheses
# of 10230 chips given the L2CM fix, 20 ms blocks), track-gps-l2cl.py
# (1.5 s period tracked in 1500 sub-blocks, RZ odd half-chips).
register(Signal(
    name="gps-l2cl", constellation="gps",
    chip_rate=gps_l2c.chip_rate, code_length=gps_l2c.cl_code_length,
    code_table=gps_l2c.cl_table, prn_all=gps_l2c.prns_all(),
    prn_default="1-32", subcarrier="rz_odd",
    acq_serial=75, acq_serial_stride=10230.0, acq_serial_scale=1.0,
    acq_serial_coh_ms=20.0,
    carrier_ratio=2400.0, el_spacing=0.5,
))

# GPS L5I / L5Q — acquire-gps-l5{i,q}.py (30.69 MHz, 1 ms, 2n pad,
# 12 MHz FIR, +-7k/200), track (ratio 115, EL 0.5).  NH10/NH20.
register(Signal(
    name="gps-l5i", constellation="gps",
    chip_rate=gps_l5.chip_rate, code_length=gps_l5.code_length,
    code_table=gps_l5.l5i_table, prn_all=gps_l5.prns_all(),
    prn_default="1-32",
    secondary=_const((1 - 2 * gps_l5.NH10.astype(np.int8))),
    acq_fs=3 * 10.23e6, acq_coherent_ms=1.0, acq_pad2=True,
    acq_lowpass_hz=12e6, doppler_default=(-7000.0, 7000.0, 200.0),
    carrier_ratio=115.0, el_spacing=0.5,
))
register(Signal(
    name="gps-l5q", constellation="gps",
    chip_rate=gps_l5.chip_rate, code_length=gps_l5.code_length,
    code_table=gps_l5.l5q_table, prn_all=gps_l5.prns_all(),
    prn_default="1-32",
    secondary=_const((1 - 2 * gps_l5.NH20.astype(np.int8))),
    acq_fs=3 * 10.23e6, acq_coherent_ms=1.0, acq_pad2=True,
    acq_lowpass_hz=12e6, doppler_default=(-7000.0, 7000.0, 200.0),
    carrier_ratio=115.0, el_spacing=0.5,
))

# =============================================================== Galileo

# E1B/E1C — acquire-galileo-e1{b,c}.py (8.192 MHz, 4 ms coherent, 2n pad
# sliding windows, BOC ref, +-9k/50), track (ratio 1540, EL 0.2, CBOC,
# 4 sub-blocks).  E1C: CS25 secondary.
register(Signal(
    name="galileo-e1b", constellation="galileo",
    chip_rate=galileo.E1_CHIP_RATE, code_length=galileo.E1_CODE_LENGTH,
    code_table=galileo.e1b_table, prn_all=galileo.memory_prns("gal_e1b"),
    prn_default="1-50", subcarrier="cboc",
    acq_fs=8.192e6, acq_coherent_ms=4.0, acq_pad2=True, acq_sliding=True,
    acq_boc_ref=True, acq_lowpass_hz=4e6,
    doppler_default=(-9000.0, 9000.0, 50.0),
    carrier_ratio=1540.0, el_spacing=0.2,
))
register(Signal(
    name="galileo-e1c", constellation="galileo",
    chip_rate=galileo.E1_CHIP_RATE, code_length=galileo.E1_CODE_LENGTH,
    code_table=galileo.e1c_table, prn_all=galileo.memory_prns("gal_e1c"),
    prn_default="1-50", subcarrier="cboc", secondary=galileo.e1c_secondary,
    acq_fs=8.192e6, acq_coherent_ms=4.0, acq_pad2=True, acq_sliding=True,
    acq_boc_ref=True, acq_lowpass_hz=4e6,
    doppler_default=(-9000.0, 9000.0, 50.0),
    carrier_ratio=1540.0, el_spacing=0.2,
))

# E5a/E5b I/Q — acquire-galileo-e5{ai,aq,bi,bq}.py (30.69 MHz, 1 ms, 2n
# pad, 12 MHz FIR, +-9k/200), track (ratio 115/118; EL 0.2 data, 0.5
# pilot).
def _e5(name, table, secondary, ratio, el):
    register(Signal(
        name=name, constellation="galileo",
        chip_rate=galileo.E5_CHIP_RATE, code_length=galileo.E5_CODE_LENGTH,
        code_table=table, prn_all=galileo.e5_prns(), prn_default="1-50",
        secondary=secondary,
        acq_fs=3 * 10.23e6, acq_coherent_ms=1.0, acq_pad2=True,
        acq_lowpass_hz=12e6, doppler_default=(-9000.0, 9000.0, 200.0),
        carrier_ratio=ratio, el_spacing=el,
    ))


_e5("galileo-e5ai", galileo.e5ai_table, galileo.e5ai_secondary, 115.0, 0.2)
_e5("galileo-e5aq", galileo.e5aq_table, galileo.e5aq_secondary, 115.0, 0.5)
_e5("galileo-e5bi", galileo.e5bi_table, galileo.e5bi_secondary, 118.0, 0.2)
_e5("galileo-e5bq", galileo.e5bq_table, galileo.e5bq_secondary, 118.0, 0.5)

# E6B/E6C — acquire-galileo-e6{b,c}.py (15.345 MHz, 1 ms, 2n pad, 6 MHz
# FIR, +-9k/200), track (ratio 250, EL 0.5).  E6C: CS100.
register(Signal(
    name="galileo-e6b", constellation="galileo",
    chip_rate=galileo.E6_CHIP_RATE, code_length=galileo.E6_CODE_LENGTH,
    code_table=galileo.e6b_table, prn_all=galileo.memory_prns("gal_e6b"),
    prn_default="1-50",
    acq_fs=3 * 5.115e6, acq_coherent_ms=1.0, acq_pad2=True,
    acq_lowpass_hz=6e6, doppler_default=(-9000.0, 9000.0, 200.0),
    carrier_ratio=250.0, el_spacing=0.5,
))
register(Signal(
    name="galileo-e6c", constellation="galileo",
    chip_rate=galileo.E6_CHIP_RATE, code_length=galileo.E6_CODE_LENGTH,
    code_table=galileo.e6c_table, prn_all=galileo.memory_prns("gal_e6c"),
    prn_default="1-50", secondary=galileo.e6c_secondary,
    acq_fs=3 * 5.115e6, acq_coherent_ms=1.0, acq_pad2=True,
    acq_lowpass_hz=6e6, doppler_default=(-9000.0, 9000.0, 200.0),
    carrier_ratio=250.0, el_spacing=0.5,
))

# ================================================================ BeiDou

# B1I / B2I — acquire-beidou-b1i.py / b2i.py (8.192 MHz, 1 ms, 2n pad,
# 3 MHz FIR), track ratios 763 (B1I) / 590 (B2I), EL 0.5.  NH20.
for _nm, _ratio in (("beidou-b1i", 763.0), ("beidou-b2i", 590.0)):
    register(Signal(
        name=_nm, constellation="beidou",
        chip_rate=beidou.B1I_CHIP_RATE, code_length=beidou.B1I_CODE_LENGTH,
        code_table=beidou.b1i_table, prn_all=beidou.b1i_prns(),
        prn_default="1-63",
        secondary=_const((1 - 2 * beidou.NH20.astype(np.int8))),
        acq_fs=8.192e6, acq_coherent_ms=1.0, acq_pad2=True,
        acq_lowpass_hz=3e6, doppler_default=(-7000.0, 7000.0, 200.0),
        carrier_ratio=_ratio, el_spacing=0.5,
    ))

# B1Cd / B1Cp — acquire-beidou-b1c{d,p}.py (8.192 MHz, 10 ms, no pad,
# BOC ref, 4 MHz FIR, +-7k/20), track (ratio 1540, EL 0.2, BOC(1,1)).
register(Signal(
    name="beidou-b1cd", constellation="beidou",
    chip_rate=beidou.B1C_CHIP_RATE, code_length=beidou.B1C_CODE_LENGTH,
    code_table=beidou.b1cd_table, prn_all=beidou.b1c_prns(),
    prn_default="1-63", subcarrier="boc11",
    acq_fs=8.192e6, acq_coherent_ms=10.0, acq_pad2=False, acq_boc_ref=True,
    acq_lowpass_hz=4e6, doppler_default=(-7000.0, 7000.0, 20.0),
    carrier_ratio=1540.0, el_spacing=0.2,
))
register(Signal(
    name="beidou-b1cp", constellation="beidou",
    chip_rate=beidou.B1C_CHIP_RATE, code_length=beidou.B1C_CODE_LENGTH,
    code_table=beidou.b1cp_table, prn_all=beidou.b1c_prns(),
    prn_default="1-63", subcarrier="boc11", secondary=beidou.b1cp_secondary,
    acq_fs=8.192e6, acq_coherent_ms=10.0, acq_pad2=False, acq_boc_ref=True,
    acq_lowpass_hz=4e6, doppler_default=(-7000.0, 7000.0, 20.0),
    carrier_ratio=1540.0, el_spacing=0.2,
))

# B2ad / B2ap — acquire-beidou-b2a{d,p}.py (30.69 MHz, 1 ms, 2n pad,
# 12 MHz FIR; quirk: b2ad hardcodes 80 blocks, acquire-beidou-b2ad.py:29
# — b2ap does NOT), track ratio 115.
register(Signal(
    name="beidou-b2ad", constellation="beidou",
    chip_rate=beidou.B2_CHIP_RATE, code_length=beidou.B2_CODE_LENGTH,
    code_table=beidou.b2ad_table, prn_all=beidou.b2a_prns(),
    prn_default="1-63",
    secondary=_const((1 - 2 * beidou.CS5.astype(np.int8))),
    acq_fs=3 * 10.23e6, acq_coherent_ms=1.0, acq_pad2=True,
    acq_lowpass_hz=12e6, acq_blocks_override=80,
    doppler_default=(-7000.0, 7000.0, 200.0),
    carrier_ratio=115.0, el_spacing=0.5,
))
register(Signal(
    name="beidou-b2ap", constellation="beidou",
    chip_rate=beidou.B2_CHIP_RATE, code_length=beidou.B2_CODE_LENGTH,
    code_table=beidou.b2ap_table, prn_all=beidou.b2a_prns(),
    prn_default="1-63", secondary=beidou.b2ap_secondary,
    acq_fs=3 * 10.23e6, acq_coherent_ms=1.0, acq_pad2=True,
    # NO 80-block override: only b2ad hardcodes range(80); b2ap sums
    # range(ms) (acquire-beidou-b2ap.py:29) — caught by the parity matrix
    acq_lowpass_hz=12e6,
    doppler_default=(-7000.0, 7000.0, 200.0),
    carrier_ratio=115.0, el_spacing=0.5,
))

# B2bi / B2bq — acquire-beidou-b2b{i,q}.py (30.69 MHz, 1 ms, 2n pad),
# track ratio 118.  The reference track scripts always run unknown-code
# recovery and dump track-chips.dat (track-beidou-b2bi.py:47-53,181-184),
# so recover_default=True: the drop-in CLI does the same by default.
register(Signal(
    name="beidou-b2bi", constellation="beidou",
    chip_rate=beidou.B2_CHIP_RATE, code_length=beidou.B2_CODE_LENGTH,
    code_table=beidou.b2bi_table, prn_all=beidou.b2b_prns(),
    prn_default="19-30,32-48",
    acq_fs=3 * 10.23e6, acq_coherent_ms=1.0, acq_pad2=True,
    acq_lowpass_hz=12e6, doppler_default=(-7000.0, 7000.0, 200.0),
    carrier_ratio=118.0, el_spacing=0.5, recover_default=True,
))
register(Signal(
    name="beidou-b2bq", constellation="beidou",
    chip_rate=beidou.B2_CHIP_RATE, code_length=beidou.B2_CODE_LENGTH,
    code_table=beidou.b2bq_table, prn_all=beidou.b2b_prns(),
    prn_default="19-30,32-48",
    acq_fs=3 * 10.23e6, acq_coherent_ms=1.0, acq_pad2=True,
    acq_lowpass_hz=12e6, doppler_default=(-7000.0, 7000.0, 200.0),
    carrier_ratio=118.0, el_spacing=0.5, recover_default=True,
))

# B3I — acquire-beidou-b3i.py (30.69 MHz, 1 ms, 2n pad), track ratio 124.
register(Signal(
    name="beidou-b3i", constellation="beidou",
    chip_rate=beidou.B3I_CHIP_RATE, code_length=beidou.B3I_CODE_LENGTH,
    code_table=beidou.b3i_table, prn_all=beidou.b3i_prns(),
    prn_default="1-63",
    secondary=_const((1 - 2 * beidou.NH20.astype(np.int8))),
    acq_fs=3 * 10.23e6, acq_coherent_ms=1.0, acq_pad2=True,
    acq_lowpass_hz=12e6, doppler_default=(-7000.0, 7000.0, 200.0),
    carrier_ratio=124.0, el_spacing=0.5,
))

# =============================================================== GLONASS

# L1/L2 C/A FDMA — acquire-glonass-l{1,2}.py (16.384 MHz, 1 ms, no pad,
# 6 MHz FIR, channel offsets 562.5/437.5 kHz), track: per-channel ratio
# (1602+0.5625*k)/0.511 resp. (1246+0.4375*k)/0.511.
register(Signal(
    name="glonass-l1", constellation="glonass",
    chip_rate=glonass.CA_CHIP_RATE, code_length=glonass.CA_CODE_LENGTH,
    code_table=glonass.ca_table, prn_all=tuple(range(-7, 8)),
    prn_default="-7:7",
    acq_fs=16.384e6, acq_coherent_ms=1.0, acq_pad2=False,
    acq_lowpass_hz=6e6, doppler_default=(-7000.0, 7000.0, 200.0),
    fdma_hz=562500.0, el_spacing=0.5,
    fdma_rf0_mhz=1602.0, fdma_step_mhz=0.5625, fdma_code_mhz=0.511,
))
register(Signal(
    name="glonass-l2", constellation="glonass",
    chip_rate=glonass.CA_CHIP_RATE, code_length=glonass.CA_CODE_LENGTH,
    code_table=glonass.ca_table, prn_all=tuple(range(-7, 8)),
    prn_default="-7:7",
    acq_fs=16.384e6, acq_coherent_ms=1.0, acq_pad2=False,
    acq_lowpass_hz=6e6, doppler_default=(-7000.0, 7000.0, 200.0),
    fdma_hz=437500.0, el_spacing=0.5,
    fdma_rf0_mhz=1246.0, fdma_step_mhz=0.4375, fdma_code_mhz=0.511,
))

# L1/L2 P — acquire-glonass-l{1,2}-p.py (assisted serial search: 1000
# hypotheses of 5110 chips, cp = 5110k + 10*ca_phase, 4 ms blocks),
# track: 1 s period in 1000 sub-blocks, ratio over 5.11.
register(Signal(
    name="glonass-l1-p", constellation="glonass",
    chip_rate=glonass.P_CHIP_RATE, code_length=glonass.P_CODE_LENGTH,
    code_table=glonass.p_table, prn_all=tuple(range(-7, 8)),
    prn_default="-7:7",
    acq_serial=1000, acq_serial_stride=5110.0, acq_serial_scale=10.0,
    acq_serial_coh_ms=4.0, fdma_hz=562500.0, el_spacing=0.5,
    fdma_rf0_mhz=1602.0, fdma_step_mhz=0.5625, fdma_code_mhz=5.11,
))
register(Signal(
    name="glonass-l2-p", constellation="glonass",
    chip_rate=glonass.P_CHIP_RATE, code_length=glonass.P_CODE_LENGTH,
    code_table=glonass.p_table, prn_all=tuple(range(-7, 8)),
    prn_default="-7:7",
    acq_serial=1000, acq_serial_stride=5110.0, acq_serial_scale=10.0,
    acq_serial_coh_ms=4.0, fdma_hz=437500.0, el_spacing=0.5,
    fdma_rf0_mhz=1246.0, fdma_step_mhz=0.4375, fdma_code_mhz=5.11,
))

# L3OCd/p — acquire-glonass-l3oc{d,p}.py (30.69 MHz, 1 ms, 2n pad,
# 12 MHz FIR, chans 0-63 CDMA), track ratio 117.5.
register(Signal(
    name="glonass-l3ocd", constellation="glonass",
    chip_rate=glonass.L3_CHIP_RATE, code_length=glonass.L3_CODE_LENGTH,
    code_table=glonass.l3ocd_table, prn_all=tuple(range(0, 64)),
    prn_default="0-63",
    secondary=_const((1 - 2 * glonass.CS5.astype(np.int8))),
    acq_fs=3 * 10.23e6, acq_coherent_ms=1.0, acq_pad2=True,
    acq_lowpass_hz=12e6, doppler_default=(-7000.0, 7000.0, 200.0),
    carrier_ratio=117.5, el_spacing=0.5,
))
register(Signal(
    name="glonass-l3ocp", constellation="glonass",
    chip_rate=glonass.L3_CHIP_RATE, code_length=glonass.L3_CODE_LENGTH,
    code_table=glonass.l3ocp_table, prn_all=tuple(range(0, 64)),
    prn_default="0-63",
    secondary=_const((1 - 2 * glonass.NH10.astype(np.int8))),
    acq_fs=3 * 10.23e6, acq_coherent_ms=1.0, acq_pad2=True,
    acq_lowpass_hz=12e6, doppler_default=(-7000.0, 7000.0, 200.0),
    carrier_ratio=117.5, el_spacing=0.5,
))
