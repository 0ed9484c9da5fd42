#!/bin/sh
# Full-sky acquisition workload on the PyTorch/CUDA port (behavioral
# contract: the reference's acquire-all.sh).  Generated by
# gnss_dsp_tpu_torch/tools/gen_compat_scripts.py from cli/workload.py's
# ACQUIRE_ALL.
#
#   sh acquire-all.sh DATA [DEST_DIR [DEVICE]]
#
# DEVICE: cuda or cpu (default cuda, or cpu while GNSS_DSP_CPU is set).
# DATA is the three-band 69.984 MHz container (tools/synth_sky.py), each
# band demuxed by tools/packet2wav_3ch.py, one process a script.

DATA=$1
DEST_DIR=${2:-acq-out}
DEVICE=${3:-cuda}
if [ -z "$3" ] && [ -n "$GNSS_DSP_CPU" ]; then
    DEVICE=cpu
    echo "acquire-all.sh: GNSS_DSP_CPU is set: every script runs on the CPU (the plain versions); DEVICE overrides it" >&2
fi
S=$(dirname "$0")
P2W="python3 $S/../tools/packet2wav_3ch.py"
mkdir -p "${DEST_DIR}"
set -e
<"${DATA}" $P2W 1 | python3 "$S"/acquire-gps-l1.py /dev/stdin 69984000 -9334875 --device "$DEVICE" >"${DEST_DIR}"/acq-gps-l1.dat
<"${DATA}" $P2W 1 | python3 "$S"/acquire-glonass-l1.py /dev/stdin 69984000 17245125 --device "$DEVICE" >"${DEST_DIR}"/acq-glonass-l1.dat
<"${DATA}" $P2W 1 | python3 "$S"/acquire-galileo-e1b.py /dev/stdin 69984000 -9334875 --device "$DEVICE" >"${DEST_DIR}"/acq-galileo-e1b.dat
<"${DATA}" $P2W 1 | python3 "$S"/acquire-galileo-e1c.py /dev/stdin 69984000 -9334875 --device "$DEVICE" >"${DEST_DIR}"/acq-galileo-e1c.dat
<"${DATA}" $P2W 1 | python3 "$S"/acquire-beidou-b1i.py /dev/stdin 69984000 -23656875 --device "$DEVICE" >"${DEST_DIR}"/acq-beidou-b1i.dat
<"${DATA}" $P2W 2 | python3 "$S"/acquire-gps-l2cm.py /dev/stdin 69984000 -127126 --device "$DEVICE" >"${DEST_DIR}"/acq-gps-l2cm.dat
<"${DATA}" $P2W 2 | python3 "$S"/acquire-glonass-l2.py /dev/stdin 69984000 18272874 --device "$DEVICE" >"${DEST_DIR}"/acq-glonass-l2.dat
<"${DATA}" $P2W 2 | python3 "$S"/acquire-glonass-l3ocd.py /dev/stdin 69984000 -25702126 --device "$DEVICE" >"${DEST_DIR}"/acq-glonass-l3ocd.dat
<"${DATA}" $P2W 2 | python3 "$S"/acquire-glonass-l3ocp.py /dev/stdin 69984000 -25702126 --device "$DEVICE" >"${DEST_DIR}"/acq-glonass-l3ocp.dat
<"${DATA}" $P2W 2 | python3 "$S"/acquire-galileo-e5bi.py /dev/stdin 69984000 -20587126 --device "$DEVICE" >"${DEST_DIR}"/acq-galileo-e5bi.dat
<"${DATA}" $P2W 2 | python3 "$S"/acquire-galileo-e5bq.py /dev/stdin 69984000 -20587126 --device "$DEVICE" >"${DEST_DIR}"/acq-galileo-e5bq.dat
<"${DATA}" $P2W 2 | python3 "$S"/acquire-beidou-b2i.py /dev/stdin 69984000 -20587126 --device "$DEVICE" >"${DEST_DIR}"/acq-beidou-b2i.dat
<"${DATA}" $P2W 3 | python3 "$S"/acquire-gps-l5i.py /dev/stdin 69984000 -15191625 --device "$DEVICE" >"${DEST_DIR}"/acq-gps-l5i.dat
<"${DATA}" $P2W 3 | python3 "$S"/acquire-gps-l5q.py /dev/stdin 69984000 -15191625 --device "$DEVICE" >"${DEST_DIR}"/acq-gps-l5q.dat
<"${DATA}" $P2W 3 | python3 "$S"/acquire-galileo-e5ai.py /dev/stdin 69984000 -15191625 --device "$DEVICE" >"${DEST_DIR}"/acq-galileo-e5ai.dat
<"${DATA}" $P2W 3 | python3 "$S"/acquire-galileo-e5aq.py /dev/stdin 69984000 -15191625 --device "$DEVICE" >"${DEST_DIR}"/acq-galileo-e5aq.dat
<"${DATA}" $P2W 3 | python3 "$S"/acquire-glonass-l3ocd.py /dev/stdin 69984000 10383375 --device "$DEVICE" >"${DEST_DIR}"/acq-glonass-l3ocd-ch3.dat
<"${DATA}" $P2W 3 | python3 "$S"/acquire-glonass-l3ocp.py /dev/stdin 69984000 10383375 --device "$DEVICE" >"${DEST_DIR}"/acq-glonass-l3ocp-ch3.dat
<"${DATA}" $P2W 3 | python3 "$S"/acquire-galileo-e5bi.py /dev/stdin 69984000 15498375 --device "$DEVICE" >"${DEST_DIR}"/acq-galileo-e5bi-ch3.dat
<"${DATA}" $P2W 3 | python3 "$S"/acquire-galileo-e5bq.py /dev/stdin 69984000 15498375 --device "$DEVICE" >"${DEST_DIR}"/acq-galileo-e5bq-ch3.dat
<"${DATA}" $P2W 3 | python3 "$S"/acquire-beidou-b2i.py /dev/stdin 69984000 15498375 --device "$DEVICE" >"${DEST_DIR}"/acq-beidou-b2i-ch3.dat
