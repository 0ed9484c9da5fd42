#!/bin/sh
# Tracking workload of the golden seeds on the PyTorch/CUDA port (behavioral
# contract: the reference's track-all-gnss-2017-L1L2L5.sh).  Generated by
# gnss_dsp_tpu_torch/tools/gen_compat_scripts.py from cli/workload.py's
# TRACK_ALL.
#
#   sh track-all-gnss-2017-L1L2L5.sh DATA [DEST_DIR [DEVICE]]
#
# DEVICE: cuda or cpu (default cuda, or cpu while GNSS_DSP_CPU is set).
# DATA is the three-band 69.984 MHz container (tools/synth_sky.py), each
# band demuxed by tools/packet2wav_3ch.py, one process a script.

DATA=$1
DEST_DIR=${2:-track-out}
DEVICE=${3:-cuda}
if [ -z "$3" ] && [ -n "$GNSS_DSP_CPU" ]; then
    DEVICE=cpu
    echo "track-all-gnss-2017-L1L2L5.sh: GNSS_DSP_CPU is set: every script runs on the CPU (the plain versions); DEVICE overrides it" >&2
fi
S=$(dirname "$0")
P2W="python3 $S/../tools/packet2wav_3ch.py"
mkdir -p "${DEST_DIR}"
set -e
<"${DATA}" $P2W 1 | python3 "$S"/track-gps-l1.py /dev/stdin 69984000 -9334875 21 2400.0 817.50 --device "$DEVICE" >"${DEST_DIR}"/track-gps-l1-prn21.dat
<"${DATA}" $P2W 1 | python3 "$S"/track-glonass-l1.py /dev/stdin 69984000 17245125 -3 -1200.0 362.82 --device "$DEVICE" >"${DEST_DIR}"/track-glonass-l1-m3.dat
<"${DATA}" $P2W 1 | python3 "$S"/track-galileo-e1b.py /dev/stdin 69984000 -9334875 24 250.0 2838.00 --device "$DEVICE" >"${DEST_DIR}"/track-galileo-e1b-prn24.dat
<"${DATA}" $P2W 1 | python3 "$S"/track-beidou-b1i.py /dev/stdin 69984000 -23656875 34 -600.0 562.20 --device "$DEVICE" >"${DEST_DIR}"/track-beidou-b1i-prn34.dat
<"${DATA}" $P2W 2 | python3 "$S"/track-gps-l2cm.py /dev/stdin 69984000 -127126 29 1120.0 4208.80 --device "$DEVICE" >"${DEST_DIR}"/track-gps-l2cm-prn29.dat
<"${DATA}" $P2W 2 | python3 "$S"/track-glonass-l2.py /dev/stdin 69984000 18272874 -2 -1800.0 470.98 --device "$DEVICE" >"${DEST_DIR}"/track-glonass-l2-m2.dat
<"${DATA}" $P2W 2 | python3 "$S"/track-glonass-l3ocd.py /dev/stdin 69984000 -25702126 9 -1800.0 9429.00 --device "$DEVICE" >"${DEST_DIR}"/track-glonass-l3ocd-prn9.dat
<"${DATA}" $P2W 2 | python3 "$S"/track-galileo-e5bi.py /dev/stdin 69984000 -20587126 24 200.0 7919.00 --device "$DEVICE" >"${DEST_DIR}"/track-galileo-e5bi-prn24.dat
<"${DATA}" $P2W 2 | python3 "$S"/track-beidou-b2i.py /dev/stdin 69984000 -20587126 14 -600.0 1682.90 --device "$DEVICE" >"${DEST_DIR}"/track-beidou-b2i-prn14.dat
<"${DATA}" $P2W 3 | python3 "$S"/track-gps-l5i.py /dev/stdin 69984000 -15191625 25 -1600.0 9696.00 --device "$DEVICE" >"${DEST_DIR}"/track-gps-l5i-prn25.dat
<"${DATA}" $P2W 3 | python3 "$S"/track-galileo-e5ai.py /dev/stdin 69984000 -15191625 24 200.0 7919.00 --device "$DEVICE" >"${DEST_DIR}"/track-galileo-e5ai-prn24.dat
