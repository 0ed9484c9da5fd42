#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gnss_dsp_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Runs every phase, in this order:
  device  require CUDA; print the card (nvidia-smi name, power limit),
          torch/CUDA versions and the TF32 flags
  build   build every kernel from gnss_dsp_tpu_torch/csrc with nvcc (one
          process per source, all at once)
  k1      acquisition-surface kernel vs its plain version at the GPS L1
          sky-search shape (32 PRN x 70 doppler x 80 blocks x 4096), the
          non-coherent BeiDou B1I shape (63 PRN x 70 doppler x 40 blocks x
          16384), the launch shapes of the wide e2e searches below (GPS
          L5I and Galileo E6B padded with n_valid, Galileo E1B, GPS L1CP,
          GPS L2CM at 65536 to 163840) and e2e_fdma's (one code row
          against 102 of the 15 x 70 channel-band dopplers x 80 blocks x
          16384) and e2e_workload's (every acquisition of acquire-all.sh
          whose launch shape is not among those: BeiDou B1I/B2I 63 x 70 x
          80 x 16384, GLONASS L3OC 64 and Galileo E5 50 x 25 x 80 x 65536
          with n_valid) and e2e_sensitivity's (BeiDou B1I at 4.096 MHz: 1
          x 9 x 40 x 8192, the run-time core on one CTA), with timings
          (the library over slices of the dopplers or of the PRNs where
          the whole transform does not fit), the kernel's plan at
          each window (core, n1 x n2, cluster size, clusters the card holds
          at once, registers, spills) and the times at the other cluster
          sizes built; then a planted exact tie across cluster ranks at
          each window, which must report the lower lag
  k1s     the same kernel's natural-order surface (reduce=False) vs its
          plain version at every launch shape of e2e_mesh: GPS L1 on one
          shard of the 2 x 2 mesh (16 PRN x 70 doppler x 40 blocks x
          4096), on the 1 x 1 mesh of acquire --mesh 1 (32 x 70 x 80) and
          on the 1 x 2 mesh of the two gloo ranks (32 x 70 x 40), GPS L2CM
          on one shard of the 2 x 2 mesh (16 x 28 x 2 x 163840, the
          run-time core) and e2e_fdma's GLONASS L1 shard of the 2 x 2 mesh
          (1 code row x 204 of its 8 channels' 560 dopplers x 40 x 16384),
          with its plan, its time beside K7's at the same
          shape and one library ifft, and the bound
  k7      full-surface kernel vs its plain version at the Xona X5 launch
          shape (1 PRN x 54 doppler x 80 blocks x 30690), at the
          sharded search's GPS L5I shard shape (16 x 70 x 40 x 61380 =
          220 x 279) and at GPS L5I's single-card launch under
          GNSS_DSP_NO_V2P (32 x 22 x 80 x 61380, one doppler chunk of
          e2e_switches'), with timings, its cluster plan (cluster size,
          clusters the card holds at once, registers, spills) and the
          times at other cluster sizes
  k5      spectral-combine coherent kernel vs its plain version at the
          BeiDou B1I --coherent 20 shape (63 PRN x 51 doppler x 2 groups x
          20 alignments x 16384) and at the launch shape of every search of
          e2e_coherent_wide (GPS L5Q and Galileo E6C padded with n_valid,
          Galileo E1C at 65536, GPS L1CD at 81920, GPS L2CM at 163840 on
          the run-time core) and e2e_fdma's GLONASS L1 --coherent 8 (1
          channel x 16 dopplers x 10 groups x 1 alignment x 16384), a
          planted cell per PRN (and on the padded
          windows a stronger one below the searched lags, which must not
          win), with timings, the library ifft, the bound, the kernel's
          plan and the times at the other cluster sizes built and, at
          16384, of surface_rows' build beside the batched core (the
          ablation, bit-equal to it); then a planted exact tie across
          cluster ranks and two alignments at each new window, which must
          report the lower lag, then the lower alignment
  k6      per-block coherent kernel (the combine, then the surface on
          the cluster core) vs its plain version at the GPS L1
          --coherent 8 shape (32 PRN x 102 doppler x 80 blocks in groups
          of 8 x 4096) and the Xona X1P --coherent 100 shape (1 PRN x 70
          doppler x 200 blocks in groups of 100 x 100 alignments x 4096),
          a planted cell per PRN, two launches bit-equal, with timings,
          the same function in PyTorch calls (matmul, ifft, abs, group
          sum, finalize_max), and e2e_sensitivity's BeiDou B1I shape (1 x
          9 x 40 blocks in groups of 20 x 20 alignments x 8192, on K5's
          register core of 8 CTAs in alignment chunks), the bound and
          beside it the bound of the
          3xTF32 combine's design, the plan (cluster, alignment chunks)
          and the times with the alignment split off or at 4 chunks (X1P,
          bit-equal); then a planted exact tie across cluster ranks and
          across two alignment chunks, which must report the lower lag,
          then the lower alignment (also at 8192)
  k2      fused tracking kernel vs its plain version at the tracking bench
          shape (32 channels x 900 blocks, 4.096 MHz), with timings; then
          at every family shape of e2e_track (galileo-e1b, gps-l1cp,
          gps-l2cm, gps-l2cl with its chips read from device memory, 4
          FDMA channels of glonass-l1-p with 5.11 M chips) and the
          e2e_coherent_track shape (6 BeiDou B1I channels at 16.368 MHz,
          M = 20) and the GPS L5Q one (4 channels at 30.69 MHz, M = 20),
          and e2e_mesh's shard shapes (4 GPS L1 channels at 8.184 MHz, 3
          B1I channels at M = 20),
          each over two launches whose chunk boundary falls
          mid-run (mid-period when coherent): int rows and state equal,
          float rows bit-equal, with timings and bounds; at each shape
          the launch plan (cluster size, staging, registers, clusters at
          once), microseconds a block and the time on one CTA a channel
          (S = 1, rows and state bit-equal to the plan's); then at the main
          path's shape (the e2e capture's 8 channels at 8.184 MHz, int8
          ingest on the card) across a chunk that ends mid-run, the stall,
          and the driver's refill with pointer rebase
  k3      per-step correlator K3 vs its plain version, every launch of a
          per-step scan on a 45 dB-Hz capture: the tracking bench shape
          (32 GPS L1 channels x 900 blocks at 4.096 MHz, the scan's rows
          against the plain loop too), the GPS L1 e2e shape and every
          e2e_track shape (subc, tmboc, L2CL's and GLONASS P's long codes);
          at each shape the cluster plan (CTAs a channel, CTAs, shared
          memory, registers, spills, clusters at once), what a call
          launches (a CUDA graph of one call: exactly one node, the step
          kernel), its device time and the launch floor's (an empty
          kernel on the same grid, cluster and shared memory), each from
          torch.profiler with the events its trace kept a call, and from
          CUDA events over replays of a graph of 50 calls
  k4      per-step correlator K4 vs its plain version for all six static
          families (none, boc11, cboc, tmboc, rz_even, rz_odd), with the
          same plan, kernel and floor lines
  track_rows
          the rows kernel (csrc/track_rows.cu) at gps-l1.track's scan: one
          K2 scan of 10 GPS L1 channels over a 2 s chunk at 69.984 MHz
          (2000 blocks, ~20,000 rows, the last blocks stalled), the
          counters past 2^31: emit_rows with a RowText on the card writes
          the bytes of the row-by-row path (format_row_14 a row) and
          leaves its counters and return value, as rows_text's head and
          text do; the kernel's time (its four launches) beside the bound
          of the rows read and the text written once, the bulk path's
          host time a scan and the row-by-row path's
  e2e     the main path through the CLIs: synthesize a 2.2 s GPS L1
          capture (8.184 MHz, 8 satellites, 45 dB-Hz), acquire it, track
          the hits for 2150 blocks (past the 2000 ms chunk refill and the
          FLL -> PLL switch at block 1000), estimate C/N0 with the
          port's cli.cn0; the launch counters must show K1 and K2
          on that path, and the rows kernel once a K2 launch
  gps_l1_routes
          the same capture tracked again on the per-step route, K3
          (GNSS_DSP_NO_FUSED=1) and K4 (and GNSS_DSP_PALLAS_V1=1): int
          columns identical to K2's and floats within rtol 2e-5 over the
          first 200 blocks, all channels in lock
  e2e_track
          the subcarrier, sub-block and long-code families through the
          track CLI on K2: 2.2 s captures at acq_fs, 8 channels each of
          galileo-e1b, gps-l1cp, gps-l2cm, gps-l2cl and 4 FDMA channels of
          glonass-l1-p at 45 dB-Hz; every channel within 5 Hz of its
          doppler over the last 200 rows, C/N0 41-47 dB-Hz (38-44 for the
          RZ codes); K3 and K4 launch no time.  Then galileo-e1b once more
          under GNSS_DSP_NO_FUSED, on the per-step route (K3)
  e2e_coherent
          the extended-coherent path through the acquire CLI: a 50 ms
          BeiDou B1I capture (16.368 MHz, 6 satellites with NH20 at
          32 dB-Hz) searched with --coherent 20 --time 40 over all 63
          PRNs on a 25 Hz grid, then --coherent 8 --time 80 on the e2e
          GPS L1 capture, then Xona X1P --coherent 100 --time 200 on a
          206 ms capture (one satellite at 45 dB-Hz carrying its 100-chip
          overlay from a random chip, its code phase in the code's first
          5% so that block m lies mostly in code period m) over +-500 Hz
          at 5 Hz: found within one bin and one chip with the truth's
          alignment (K6 at A = 100); the launch counters must show K5 and
          K6 there
  e2e_coherent_track
          the weak-signal workflow at full size: a 1.2 s BeiDou B1I
          capture (16.368 MHz, 6 satellites at 32 dB-Hz, all from one
          overlay phase, dopplers within 4 Hz of the 25 Hz grid), the
          coherent acquisition (the acquire CLI's --coherent 20 --time 40
          path over all 63 PRNs, K5) hands doppler, code and
          track_overlay_phase to the track CLI with --coherent 20
          --overlay-phase k --carrier-phase 0 on K2: the overlay phase
          equals the truth, the mean carrier_f of the last 200 rows
          within 1 Hz of the truth and its spread under 1 Hz, C/N0 of the
          last 500 rows within 3 dB of 32; then the same workflow on GPS
          L5Q (a 1.2 s capture at 30.69 MHz, 4 satellites at 32 dB-Hz
          from one NH20 phase; K5 at the padded 65536 window over +-500
          Hz, then track --coherent 20 on K2) with the same checks
  e2e_wide
          the wide-window and odd-length searches through the acquire CLI,
          one 85 ms capture per route at the signal's internal rate (four
          satellites at 45 dB-Hz, Xona X5 its one), default PRNs and
          doppler grid, --time 80: xona-x5d (K7), gps-l5i and galileo-e6b
          (K1 padded, n_valid), galileo-e1b, gps-l1cp and gps-l2cm (K1 at
          65536, 81920, 163840); the launch counters must show K7 on
          xona-x5d and K1 on the others
  e2e_coherent_wide
          the extended-coherent searches at the wide windows through the
          acquire CLI, one capture per window class at the signal's acq_fs
          and default PRNs, the doppler grid about 1 / (2 x the coherent
          span) over +-500 Hz: gps-l5q --coherent 20 --time 40 (65536
          padded), galileo-e1c --coherent 25 --time 104 (65536, CS25, the
          FFT combine), galileo-e6c --coherent 100 --time 100 (32768
          padded, CS100 per PRN: one K5 call a PRN), each 4 satellites at
          32 dB-Hz from random overlay phases; gps-l1cd --coherent 2
          --time 20 (81920) and gps-l2cm --coherent 2 --time 60 (163840),
          4 satellites at 45 dB-Hz with no data-bit change: every planted
          PRN within one bin and one chip with the truth's alignment and
          above every absent PRN; the launch counters must show K5 on each
  e2e_mesh
          the sharded paths (gnss_dsp_tpu_torch.parallel): (a) acquire
          --mesh 1 on the e2e GPS L1 capture (a 1 x 1 mesh: K1's surface
          and the torch reduction): its rows text for text the single-card
          CLI's, or, where the metric's last digit differs, the winners
          equal and the metric within rtol 1e-5; (b) acquire_signal_sharded
          on a 2 x 2 mesh over the one card for GPS L1 (K1's surface),
          GPS L5I (K7 at 61380) and GPS L2CM (K1's surface at 163840), one
          85 ms capture each: every planted PRN within one doppler bin and
          one chip, above every absent PRN; (c) track --mesh 2 over two
          sat shards of the card (shards of 4 channels, K2 at the shard's
          cluster size) on the e2e channels, and with --coherent 20 on the
          six B1I ones of e2e_coherent_track: rows byte-equal to the
          single-card CLI's; (d) the GPS L1 search as two
          tools/multihost_worker ranks sharing the card over gloo on a 1 x 2
          mesh (the sum over time shards crosses the ranks): winners equal
          to (a)'s, metric within rtol 1e-5
  e2e_fdma
          GLONASS FDMA through the acquire CLI: a GLONASS L1 capture at
          16.384 MHz (4 channels at 45 dB-Hz within +-450 Hz among the
          default -7:7), default grid, --time 80: every live channel within
          one bin and one chip, above every dead one (K1, one code row);
          the search's device time and cells per second (15 x 70 x 16384 x
          80 cells); --mesh on a 2 x 2 mesh of the card equal to it
          (channel, doppler and code exact, metric rtol 1e-5; K1's
          surface); --coherent 8 over +-500 Hz at 62.5 Hz (K5, one launch a
          channel) finding the live channels; GLONASS L2 once through the
          plain CLI
  e2e_serial
          the assisted serial searches through the acquire CLI: GPS L2CL at
          4.096 MHz (--time 40, 75 hypotheses) and GLONASS L1 P at 16.384
          MHz (--time 80, 1000 hypotheses, FDMA channel 3), one satellite
          at 45 dB-Hz planted at hypothesis k: k and its code phase printed
          exactly, q at k within rtol 1e-6 of a float64 host evaluation,
          and serial_search_sharded on a 2 x 2 mesh of the card the same k
          and metric (rtol 1e-5), with the walls
  e2e_switches
          the reference's route switches through the CLIs (after
          e2e_mesh): GNSS_DSP_NO_V2P on an 85 ms GPS L5I capture at
          30.69 MHz takes K7 at 61380 (counted by its wrapper and seen in
          torch.profiler's events) and no K1, with the padded route's
          winners; GNSS_DSP_NO_PALLAS on the e2e GPS L1 capture: acquire,
          acquire --coherent 2, acquire --mesh 1, track and track multi
          on the card each refuse the switch, naming it, with no kernel
          launched and no plain route called (the port runs only its
          kernels on a card); with the switches unset K1 and K2 launch
          and the plain routes are never called; GNSS_DSP_CPU, set only
          there: the GPS L1 acquire (three planted PRNs) and track (100
          blocks) CLIs without --device print their --device cpu rows and one stderr
          line naming it, with no kernel launched, and with --device cuda
          launch K1 once and K2 once, the rows the unset run's;
          GNSS_DSP_TIMING: the GPS L1 acquire and track (2150 blocks) CLIs
          on the card print the reference's stage walls, their rows
          byte-equal to the unset runs'
  e2e_aux the squaring CLI on the card against --device cpu (int16 equal
          but for rounding ties, counted), correlation_shape on the card
          against the CPU (rtol 1e-5), utils/profiling.trace writing the
          card's kernels into its trace
  e2e_sensitivity
          tools/sensitivity_curve's default curve on the card (BeiDou B1I
          at 4.096 MHz, PRN 34, 6 C/N0 points 24-34 dB-Hz x 10 trials, K1
          and K6 at 8192), then the same tool on the CPU (the plain
          versions) on the same captures at 28 and 34 dB-Hz: winning
          cells and lock decisions equal, but for near ties (metrics
          within rtol 1e-4, printed, at most one a point); coherent locks
          10/10 at 34 dB-Hz and at least the non-coherent ones in sum
  e2e_workload (last)
          the reference's whole workload, acquire-all.sh's 21
          acquisitions and track-all-gnss-2017-L1L2L5.sh's 11 tracks, in
          one process (cli/workload all) on the 2017 three-band sky (1.5 s
          at 69.984 MHz, 45 dB-Hz; the bands synthesised on the card and
          interleaved into the tools/synth_sky container): each track's
          whole-band K2 scan held against the plain version for 40 blocks
          from block 1000 (the pointer ~70 M samples into the chunk);
          then the run, K1 the only acquisition kernel and one K2 launch
          a track, tools/sky_workload.validate on all 32 files, each file
          byte-equal to the same CLI call without the cache, the stage
          walls; then the run again under torch.profiler (busy and idle
          share, files equal again)

In the e2e phases every surface-kernel, per-step correlator and K2 call
is recorded with its shape, and each must have been held against its
plain version at that shape in k1, k1s, k2, k3, k4, k5, k6 or k7 (a surface
launch's doppler count may be smaller; K2's shape is its subcarrier kind,
channels, nmax, code length and coherent span, its block count a loop
bound).  Every rows-kernel call there is held itself, as it is made: its
text, line count, flags and final counters against what the row-by-row
path (emit_rows with a plain emit) makes of the same rows.

Prints a JSON line of per-kernel results (times, the bound the card's
peaks put on each kernel's work, the time of one torch.fft.ifft over the
same product where one exists, for K6 of the same function in PyTorch
calls), then the nvidia-smi line, then a last line {"ok": true,
"device": {...}}.  Exits non-zero, without that line, when any phase fails
or no GPU is present, and at its start when GNSS_DSP_CPU is set (it
would pin the port's CLIs to the CPU).  Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

KERNELS = {
    "acquire2": dict(route="cuda", source="gnss_dsp_tpu_torch/csrc/acquire2.cu",
                     replaces="gnss_dsp_tpu/ops/pallas_acquire2.py:285"),
    "track_fused": dict(route="cuda",
                        source="gnss_dsp_tpu_torch/csrc/track_fused.cu",
                        replaces="gnss_dsp_tpu/ops/pallas_track_fused.py:536"),
    "acquire_coh_spec": dict(
        route="cuda", source="gnss_dsp_tpu_torch/csrc/acquire_coh_spec.cu",
        replaces="gnss_dsp_tpu/ops/pallas_acquire_coh.py:273"),
    "acquire_coh": dict(
        route="cuda", source="gnss_dsp_tpu_torch/csrc/acquire_coh.cu",
        replaces="gnss_dsp_tpu/ops/pallas_acquire_coh.py:467"),
    "acquire": dict(route="cuda", source="gnss_dsp_tpu_torch/csrc/acquire.cu",
                    replaces="gnss_dsp_tpu/ops/pallas_acquire.py:183"),
    # K1 with reduce=False and K7 at 61380, the sharded search's kernels
    "acquire2_surface": dict(
        route="cuda", source="gnss_dsp_tpu_torch/csrc/acquire2.cu",
        replaces="gnss_dsp_tpu/ops/pallas_acquire2.py:285"),
    "acquire_61380": dict(
        route="cuda", source="gnss_dsp_tpu_torch/csrc/acquire.cu",
        replaces="gnss_dsp_tpu/ops/pallas_acquire.py:183"),
    "track_step_v2": dict(route="cuda",
                          source="gnss_dsp_tpu_torch/csrc/track_step.cu",
                          replaces="gnss_dsp_tpu/ops/pallas_track2.py:386"),
    "track_step_v1": dict(route="cuda",
                          source="gnss_dsp_tpu_torch/csrc/track_step.cu",
                          replaces="gnss_dsp_tpu/ops/pallas_track.py:274"),
    # no TPU kernel: the reference formats a row at a time on the host
    "track_rows": dict(route="cuda",
                       source="gnss_dsp_tpu_torch/csrc/track_rows.cu",
                       replaces="gnss_dsp_tpu/track/driver.py:505 (host)"),
}
# kernels no single PyTorch call computes (no library time)
NO_LIBRARY = ("track_fused", "track_step_v2", "track_step_v1", "track_rows")

# the subcarrier, sub-block and long-code families of e2e_track: (signal,
# channels), each at its acq_fs
E2E_TRACK = (("galileo-e1b", 8), ("gps-l1cp", 8), ("gps-l2cm", 8),
             ("gps-l2cl", 8), ("glonass-l1-p", 4))
# K4's static families, each at the e2e shape of a signal that carries it
K4_FAMILIES = (("none", "gps-l1"), ("boc11", "gps-l1cd"),
               ("cboc", "galileo-e1b"), ("tmboc", "gps-l1cp"),
               ("rz_even", "gps-l2cm"), ("rz_odd", "gps-l2cl"))

# the FDMA searches of e2e_fdma (one capture each at acq_fs, default
# channels and grid), and its coherent search: (signal, M, --time ms,
# doppler step over +-500 Hz)
E2E_FDMA = ("glonass-l1", "glonass-l2")
FDMA_COHERENT = ("glonass-l1", 8, 80, 62.5)
# the assisted serial searches of e2e_serial through the acquire CLI:
# (signal, capture rate, --time ms, PRN or FDMA channel, planted
# hypothesis k, parent code phase, doppler)
E2E_SERIAL = (("gps-l2cl", 4.096e6, 40, 5, 31, 1234.0, 250.0),
              ("glonass-l1-p", 16.384e6, 80, 3, 417, 33.0, -700.0))

# the wide-window and odd-length searches of e2e_wide, one per route
E2E_WIDE = ("xona-x5d", "gps-l5i", "galileo-e6b", "galileo-e1b", "gps-l1cp",
            "gps-l2cm")

# cluster sizes timed beside the kernels' own choice (K7: 4; K1 and K5:
# the other sizes of their register core's builds, and at 81920 the
# run-time core on 8 CTAs, its core before the 320-point register
# transform)
K5_CLUSTERS = {32768: (8,), 65536: (16,), 81920: (8,)}
# K7's cluster sizes up to 8 that hold the row (the ablation runs those
# the kernel does not choose)
K7_CLUSTERS = {30690: (4, 5, 6, 7, 8), 61380: (7, 8)}
K1_CLUSTERS = {4096: (1, 4, 8), 32768: (16,), 65536: (16,), 81920: (8,)}
# the cluster kernels' entry functions in nvcc's -Xptxas -v output
CLUSTER_KERNELS = (r"coh_spec_kernel|coh_wide_kernel|full_kernel"
                   r"|combine_stream|combine_mma"
                   r"|acq2_split_kernel|acq2_wide_kernel|track_fused_kernel"
                   r"|step_kernel")

# published peaks of one H100 SXM (NVIDIA data sheet): device memory and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12       # dense, on the tensor cores
# what K6's design_bound_ms counts (kernels line, shapes)
K6_DESIGN_BOUND = ("the 3xTF32 design's bound: 3 TF32 products a combine "
                   "value at the dense TF32 rate, then the surface's float32 "
                   "operations (A = 1: the bound)")


def log(msg):
    print(msg, flush=True)


def check(ok, what="check failed"):
    """A failed check raises (unlike assert, also under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over
    the float32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def row_flops(W):
    """Operations per transformed row value: 6 for code x conj(F), the
    usual 5 log2 W of an FFT, 4 for |.|, 1 for the sum over rows."""
    return 6 + 5 * math.log2(W) + 4 + 1


def surface_bound(P, DC, rows, W, out_bytes):
    """bound() of a surface over [P, DC, rows, W]: F and the code read
    once, the outputs written once."""
    return bound(DC * rows * W * 8 + P * W * 8 + out_bytes,
                 P * DC * rows * W * row_flops(W))


def library_ms(code_f, F, reps=2):
    """(ms, calls): milliseconds of torch.fft.ifft over the [DC, P, rows,
    W] product code_f[p] * conj(F[d, r]) of all DC dopplers of F, formed
    outside the timing.  One call where the product, its transform and
    cuFFT's workspace (about three products) fit in four fifths of free
    memory; else consecutive calls over slices of the dopplers, each
    transform and its workspace beside the whole product, in one timed
    window; where the whole product does not fit beside one doppler's
    transform, the sum of the times over slices of the PRNs, each slice's
    product (all dopplers) formed and timed on its own.  (None, 0) where
    not even one PRN's fits."""
    import torch

    DC, P = F.shape[0], code_f.shape[0]
    per_d = P * F[0].numel() * 8
    free = 0.8 * torch.cuda.mem_get_info()[0]
    d = DC if 3 * DC * per_d <= free else int((free - DC * per_d)
                                              // (2 * per_d))
    if d < 1:
        pc = int(free // (3 * DC * per_d // P))
        if pc < 1:
            return None, 0
        ms = 0.0
        for p0 in range(0, P, pc):
            prod = (code_f[p0:p0 + pc][None, :, None, :]
                    * torch.conj(F)[:, None])
            ms += cuda_ms(lambda: torch.fft.ifft(prod, dim=-1), reps)
            del prod
            torch.cuda.empty_cache()
        return ms, -(-P // pc)
    prod = code_f[None, :, None, :] * torch.conj(F)[:, None]
    slices = [prod[d0:d0 + d] for d0 in range(0, DC, d)]

    def run():
        for sl in slices:
            torch.fft.ifft(sl, dim=-1)

    ms = cuda_ms(run, reps)
    calls = len(slices)
    del prod, slices
    torch.cuda.empty_cache()
    return ms, calls


def plan_text(info, sms):
    """One line of a cluster kernel's launch plan (ops' launch_info)."""
    per_sm = info["active"] * info["cluster"] / sms
    core = (f"{info['core']} core, {info['n1']} x {info['n2']}, "
            if "core" in info else "")
    threads = f"{info['threads']} threads, " if "threads" in info else ""
    return (f"{core}cluster of {info['cluster']} CTAs, {threads}"
            f"{info['active']} clusters at once ({per_sm:.2f} CTAs per SM), "
            f"{info['regs']} registers and {info['spill_bytes']} local bytes "
            f"a thread, {info['smem']} bytes of shared memory a CTA")


def library_text(lib, ms=None) -> str:
    """library_ms's time, its calls, and the kernel's ms over it."""
    t, calls = lib
    if t is None:
        return "not run (no PRN's transform fits)"
    return (f"{t:.3f} ms" + (f" in {calls} calls over doppler or PRN "
                             f"slices (the whole transform does not fit at "
                             f"once)" if calls > 1 else "")
            + (f" (kernel / library {ms / t:.3f})" if ms else ""))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, CUDA events, after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs: the summed time of
    the kernels and copies it launches, from torch.profiler with CUDA
    activity, after one warm-up run.  For calls whose host side is longer
    than their device work, where CUDA events time the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    # the profiler's trace came back empty three times (it does so now
    # and then on the card): CUDA events, which also time the host side
    log("device_ms: the profiler saw no device time in three tries; "
        "this time is from CUDA events")
    return cuda_ms(fn, reps)


# --------------------------------------------- shapes checked vs main path

# the surface kernels' wrappers, by kernel: (module under ops, function)
SURFACE_WRAPPERS = {
    "acquire2": ("acquire2", "corr_surface2"),
    "acquire": ("acquire", "corr_surface"),
    "acquire_coh_spec": ("acquire_coh", "corr_surface_coh_spec"),
    "acquire_coh": ("acquire_coh", "corr_surface_coh"),
}
# the per-step correlators' wrappers (ops.track_step), by kernel
STEP_WRAPPERS = {"track_step_v2": "epl_correlate2",
                 "track_step_v1": "epl_correlate"}
# shape_key of every case the k phases held against its plain version
CHECKED = {name: [] for name in (*SURFACE_WRAPPERS, *STEP_WRAPPERS,
                                 "track_fused", "track_rows")}


def shape_key(name, F, code_f, *rest):
    """(doppler count, the rest of the shape) of a wrapper call: P, the
    spectra's rows and W, then K1's n_valid and reduce, K5's A and n_valid
    or K6's A, m_coh and n_valid (n_valid defaults to 0, reduce to
    True)."""
    key = (code_f.shape[0], *F.shape[1:])
    if name == "acquire2":               # n_valid, reduce
        key += (rest[0] if rest else 0, rest[1] if len(rest) > 1 else True)
    elif name == "acquire_coh_spec":     # A, n_valid
        key += (rest[0], rest[1] if len(rest) > 1 else 0)
    elif name == "acquire_coh":          # cos, sin, sec_mat, m_coh, n_valid
        key += (rest[2].shape[0], rest[3], rest[4] if len(rest) > 4 else 0)
    return F.shape[0], key


def step_key(name, si, sf, x, code, nmax, sub, lens=None):
    """(0, (subcarrier, channels, nmax, code length)) of a per-step
    correlator call: its launch grid and the kernel's template; with
    per-channel code lengths (a mixed-signal table) "lens" after it."""
    key = (sub, si.shape[0], int(nmax), code.shape[1])
    return 0, key + (() if lens is None else ("lens",))


def fused_key(name, x, chunk_len, code_tab, state, params, *rest):
    """(0, (kind, channels, nmax, code length, coherent span)) of a K2
    call: the kernel's template and grid and the loop's lanes; the block
    count is a loop bound."""
    from gnss_dsp_tpu_torch.ops.track_step import subc_kind

    return 0, (subc_kind(params.subcarrier), code_tab.shape[0],
               int(params.nmax), code_tab.shape[1], int(params.coh_blocks))


def rows_key(name, rows_f, rows_i, nb, n_emit, *rest):
    """(blocks, (channels, emitted channels)) of a rows_text call."""
    return int(nb), (rows_f.shape[1], int(n_emit))


def rows_rowwise(rows_f, rows_i, nb, n_emit, prefix, prefix_off, wide,
                 counters):
    """What the row-by-row path (track/driver.emit_rows with a plain
    emit, format_row_14 or format_row_9 a row) makes of rows_text's
    arguments: (text bytes, lines, any channel ran, each emitted
    channel's samp, code_cyc and carrier_cyc after the scan)."""
    from gnss_dsp_tpu_torch.track import driver
    from gnss_dsp_tpu_torch.track.rows import format_row_9, format_row_14

    pre, off = bytes(prefix.cpu().numpy()), prefix_off.tolist()
    wd = wide.tolist()
    chans = [driver.TrackChannel(prn=0, doppler=0.0, code_offset=0.0)
             for _ in range(rows_f.shape[1])]
    for ch, (samp, code_cyc, carrier_cyc) in zip(chans, counters.tolist()):
        ch.samp, ch.code_cyc, ch.carrier_cyc = samp, code_cyc, carrier_cyc
    lines = []

    def emit(k, row):
        fmt = format_row_14 if wd[k] else format_row_9
        lines.append(pre[off[k]:off[k + 1]].decode("ascii") + fmt(row)
                     + "\n")

    any_row = driver.emit_rows(chans, n_emit, emit, rows_f, rows_i, nb)
    return ("".join(lines).encode("ascii"), len(lines), any_row,
            [[c.samp, c.code_cyc, c.carrier_cyc] for c in chans[:n_emit]])


def hold_rows(args, out):
    """One rows_text call of the main path held against the row-by-row
    path on its own rows: text bytes, lines, the any-row flag and the
    final counters equal; a flagged scan writes nothing."""
    head, text = out
    h = head.cpu().numpy()
    if h[3]:
        # a field past the fixed-point range: no text, and emit_rows
        # formats the scan a row at a time
        check(h[0] == h[1] == 0, ("track_rows", "flagged with text", h[:4]))
        log(f"[track_rows] a main-path scan at {rows_key('', *args)} "
            f"flagged: formatted a row at a time")
        return
    want, lines, any_row, final = rows_rowwise(*args)
    got = bytes(text[:int(h[0])].cpu().numpy())
    check(got == want, ("track_rows", "text differs from the row-by-row "
                        "path", len(got), len(want)))
    check(h[1] == lines and bool(h[2]) == any_row
          and h[4:].reshape(-1, 3).tolist() == final,
          ("track_rows", "head differs from the row-by-row path",
           h[:4].tolist(), lines, any_row))


@contextlib.contextmanager
def recording():
    """Yields a list that collects (kernel, shape_key) for every surface,
    per-step correlator, K2 and rows-kernel wrapper call made inside.  The
    engines call the wrappers through their ops module, so wrapping the
    module attribute sees every call; the launch counters are the
    wrappers' own and count as before.  Each rows_text call is held
    against the row-by-row path as it returns (hold_rows)."""
    calls, saved = [], []
    spies = [(name, mod, fn, shape_key, None)
             for name, (mod, fn) in SURFACE_WRAPPERS.items()]
    spies += [(name, "track_step", fn, step_key, None)
              for name, fn in STEP_WRAPPERS.items()]
    spies += [("track_fused", "track_fused", "track_scan_fused", fused_key,
               None),
              ("track_rows", "track_rows", "rows_text", rows_key,
               hold_rows)]
    for name, mod, fn, key, hold in spies:
        m = importlib.import_module(f"gnss_dsp_tpu_torch.ops.{mod}")
        orig = getattr(m, fn)

        def spy(*a, _name=name, _orig=orig, _key=key, _hold=hold, **kw):
            check(not kw, (_name, "called with keywords", sorted(kw)))
            calls.append((_name, _key(_name, *a)))
            out = _orig(*a)
            if _hold is not None:
                _hold(a, out)
            return out

        saved.append((m, fn, orig))
        setattr(m, fn, spy)
    try:
        yield calls
    finally:
        for m, fn, orig in saved:
            setattr(m, fn, orig)


def check_covered(tag, calls):
    """Every surface-kernel, per-step correlator and K2 call of the main
    path was held against its plain version at its shape.  A launch may cover fewer dopplers than
    the checked case (the grid's last chunk): the doppler count only
    sizes the launch grid, one CTA per (PRN, doppler, alignment).  The
    rows kernel's calls were each held as they returned (hold_rows)."""
    for name, (dc, key) in sorted(set(calls)):
        if name == "track_rows":
            how = "each held byte for byte against the row-by-row path"
        else:
            check(any(key == k and dc <= d for d, k in CHECKED[name]),
                  (tag, name, "main-path shape not checked", dc, key,
                   CHECKED[name]))
            how = "shape checked against the plain version"
        log(f"[{tag}] {name} launched at DC={dc} {key}: "
            f"{sum(c == (name, (dc, key)) for c in calls)} call(s), {how}")


# ---------------------------------------------------------------- phase k1

def _k1_case(dev, card, tag, P, DC, B, W, seed, plant_seed, n_valid=0,
             reps=5, plain_reps=2):
    import torch

    from gnss_dsp_tpu_torch.ops import acquire2

    g = torch.Generator(device=dev).manual_seed(seed)
    code_f = torch.exp(1j * 2 * np.pi * torch.rand(
        (P, W), generator=g, device=dev)).to(torch.complex64)
    F = torch.complex(torch.randn((DC, B, W), generator=g, device=dev),
                      torch.randn((DC, B, W), generator=g, device=dev))
    # one planted correlation peak per PRN: F[d, b] += code_f[p] e^{-2pi i k j/W}
    # (code_f * conj(F) = e^{+2 pi i k j/W}: its inverse DFT peaks at -j),
    # among the searched lags >= lo = W - n_valid
    rng = np.random.default_rng(plant_seed)
    dops = rng.permutation(DC)[:P] if P <= DC else rng.integers(0, DC, P)
    lo = W - n_valid if n_valid else 0
    if n_valid:
        want = lo + rng.integers(0, n_valid, P)
        lags = (-want) % W
    else:
        lags = rng.integers(0, W, P)
        want = (-lags) % W
    k = torch.arange(W, device=dev, dtype=torch.float64)
    for p in range(P):
        ramp = torch.exp(-2j * np.pi * k * float(lags[p]) / W)
        F[int(dops[p])] += 0.5 * (code_f[p].to(torch.complex128)
                                  * ramp).to(torch.complex64)[None, :]
    args = (F, code_f, n_valid)
    CHECKED["acquire2"].append(shape_key("acquire2", *args))
    peak_k, idx_k, sum_k = acquire2.corr_surface2(*args)
    peak_p, idx_p, sum_p = acquire2.corr_surface2_plain(*args)
    again = acquire2.corr_surface2(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip((peak_k, idx_k, sum_k),
                                                 again)),
          (tag, "two launches differ"))
    idx_k, idx_p = idx_k.cpu().numpy(), idx_p.cpu().numpy()
    peak_k, peak_p = peak_k.cpu().numpy(), peak_p.cpu().numpy()
    sum_k, sum_p = sum_k.cpu().numpy(), sum_p.cpu().numpy()
    planted_k = idx_k[np.arange(P), dops]
    check((planted_k == want - lo).all(), (tag, "planted lag", planted_k,
                                           want - lo))
    check((idx_p[np.arange(P), dops] == want - lo).all())
    np.testing.assert_allclose(peak_k, peak_p, rtol=1e-4)
    np.testing.assert_allclose(sum_k, sum_p, rtol=1e-4)
    # away from the planted cells the surface is noise: a differing argmax
    # is allowed only where the plain surface ties at both lags to float32
    # rounding
    diff = np.argwhere(idx_k != idx_p)
    for p, d in diff:
        q = torch.fft.ifft(code_f[p] * torch.conj(F[d]), dim=-1).abs().sum(0)
        a, b = float(q[lo + idx_k[p, d]]), float(q[lo + idx_p[p, d]])
        check(abs(a - b) <= 1e-5 * b, (tag, "argmax differs", p, d, a, b))
    err = float(max(np.abs(peak_k - peak_p).max(), np.abs(sum_k - sum_p).max()))
    ms = cuda_ms(lambda: acquire2.corr_surface2(*args), reps)
    plain_ms = cuda_ms(lambda: acquire2.corr_surface2_plain(*args), plain_reps)
    lib = library_ms(code_f, F)
    bms, by = surface_bound(P, DC, B, W, P * DC * 12)
    cells = P * DC * B * W
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    info = acquire2.launch_info(W, dev.index or 0)
    log(f"[k1] {tag}: P={P} DC={DC} B={B} W={W} n_valid={n_valid}: idx "
        f"exact on planted cells, {len(diff)} near-tie argmax differences "
        f"elsewhere, max|dpeak|,|dsum| = {err:.3g}, two launches bit-equal")
    log(f"[k1] {tag}: plan: {plan_text(info, sms)}")
    log(f"[k1] {tag}: kernel {ms:.3f} ms ({cells / ms / 1e6:.4g} "
        f"Gcells/s), plain {plain_ms:.3f} ms, library ifft "
        f"{library_text(lib, ms)}, bound {bms:.3f} ms by {by}  [{card}]")
    for c in K1_CLUSTERS.get(W, ()):
        got = acquire2.corr_surface2(*args, cluster=c)
        torch.cuda.synchronize()
        check((got[1].cpu().numpy()[np.arange(P), dops] == want - lo).all(),
              (tag, c, "planted lag"))
        np.testing.assert_allclose(got[0].cpu().numpy(), peak_p, rtol=1e-4)
        np.testing.assert_allclose(got[2].cpu().numpy(), sum_p, rtol=1e-4)
        ms_c = cuda_ms(lambda: acquire2.corr_surface2(*args, cluster=c), reps)
        other = acquire2.launch_info(W, dev.index or 0, c)
        log(f"[k1] {tag}: ablation, {c} CTAs a cluster: {ms_c:.3f} ms "
            f"against {ms:.3f}; {plan_text(other, sms)}; planted lags exact, "
            f"peak and sum within rtol 1e-4  [{card}]")
    del F, args
    torch.cuda.empty_cache()
    shape = dict(shape=f"{P} x {DC} x {B} x {W}" + (
        f", n_valid {n_valid}" if n_valid else ""), signal=tag, ms=ms,
        plain_ms=plain_ms, library_ms=lib[0], library_calls=lib[1],
        bound_ms=bms, k1_over_library=ms / lib[0] if lib[0] else None)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib[0], bound_ms=bms, bound_by=by,
                shape=shape)


def wide_launch(name, ms=80):
    """(route, P, DC, B, W, n_valid) of the first (largest) surface-kernel
    launch of the acquire CLI on `name` at its default PRNs and doppler
    grid, as the engine plans it."""
    from gnss_dsp_tpu_torch.acquire import engine
    from gnss_dsp_tpu_torch.acquire.plan import acq_plan
    from gnss_dsp_tpu_torch.models import get_signal

    sig = get_signal(name)
    route, W, _, n_valid = acq_plan(sig)
    P = len(sig.prns())
    B = engine._block_count(sig, ms)
    D = len(engine.doppler_grid(sig, sig.doppler_default)[0])
    return route, P, engine.dop_chunk_for(route, P, B, W, D), B, W, n_valid


def fdma_launch(name, ms=80):
    """(P, DC, B, W) of the first (largest) K1 launch of the acquire CLI's
    FDMA search on `name` (acquire_signal_fdma) at its default channels
    and doppler grid: one code row against the C x D increments in
    dop_chunk_for's chunks."""
    from gnss_dsp_tpu_torch.acquire import engine
    from gnss_dsp_tpu_torch.acquire.plan import acq_plan
    from gnss_dsp_tpu_torch.models import get_signal

    sig = get_signal(name)
    route, W, _, _ = acq_plan(sig)
    check(route == "v2", (name, "route", route))
    B = engine._block_count(sig, ms)
    CD = len(sig.prns()) * len(engine.doppler_grid(sig,
                                                   sig.doppler_default)[0])
    return 1, engine.dop_chunk_for(route, 1, B, W, CD), B, W


def workload_launches() -> dict:
    """{signal: (P, DC, B, W, n_valid)} of the first (largest) K1 launch
    of each acquisition of cli/workload.ACQUIRE_ALL, as the acquire CLI
    plans it at its default PRNs, grid and --time (80 ms for all)."""
    from gnss_dsp_tpu_torch.cli.workload import ACQUIRE_ALL
    from gnss_dsp_tpu_torch.models import get_signal

    out = {}
    for _band, name, _co, _out in ACQUIRE_ALL:
        sig = get_signal(name)
        check(sig.acq_ms_default == 80, (name, sig.acq_ms_default))
        if sig.fdma_hz:
            out[name] = fdma_launch(name) + (0,)
        else:
            route, *launch = wide_launch(name)
            check(route in ("v2", "v2p"), (name, "route", route))
            out[name] = tuple(launch)
    return out


def sensitivity_launches():
    """The K1 and K6 launch shapes of tools/sensitivity_curve's default
    curve (BeiDou B1I at acq_fs 4.096 MHz, PRN 34, twice the 20-chip
    overlay of data, its 9-doppler grid), as the engines plan them:
    ((P, DC, B, W, n_valid), (P, DC, B, m_coh, overlay, W))."""
    import dataclasses

    from gnss_dsp_tpu_torch.acquire import engine
    from gnss_dsp_tpu_torch.acquire.coherent import coh_dop_chunk
    from gnss_dsp_tpu_torch.acquire.plan import acq_plan, coh_plan
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools import sensitivity_curve as sc

    sig = dataclasses.replace(get_signal("beidou-b1i"), acq_fs=4.096e6)
    sec = sig.secondary(34)
    m = len(sec)
    ms = 2 * m
    D = len(engine.doppler_grid(sig, sc.GRID)[0])
    route, W, _, n_valid = acq_plan(sig)
    check(route == "v2", ("sensitivity route", route))
    B = engine._block_count(sig, ms)
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    fast = coh_plan(sig, n, m, m)
    check(fast is not None and fast[0] == "blk", ("sensitivity", fast))
    blocks = max(int(ms / sig.acq_coherent_ms) // m, 1) * m
    return ((1, engine.dop_chunk_for(route, 1, B, W, D), B, W, n_valid),
            (1, coh_dop_chunk(fast, 1, blocks, m, m, fast[1], D), blocks, m,
             sec, fast[1]))


def _k1_tie(dev, card, W, B=2):
    """K1 on a row whose surface ties exactly at every lag with an even
    row index j mod n1: X = code * conj(F) = delta[0] + delta[(n1/2) n2],
    whose column IDFT is 1 + (-1)^j1 on column 0 alone, so that every
    product the kernel forms is by a unit twiddle or by zero.  From lag 0
    the lowest tied lag is 0 (rank 0); from lo = nr - 1 it is nr, made by
    rank 1 while rank 0 makes the tied lag n1: the kernel must report
    idx 0 and 1."""
    import torch

    from gnss_dsp_tpu_torch.ops import acquire2

    _, n1, n2, C = acquire2.core_plan(W)
    nr = -(-n1 // C)
    code = torch.ones((1, W), dtype=torch.complex64, device=dev)
    F = torch.zeros((1, B, W), dtype=torch.complex64, device=dev)
    F[:, :, 0] = 1.0
    F[:, :, (n1 // 2) * n2] = 1.0
    got = [acquire2.corr_surface2(F, code, nv) for nv in (0, W - (nr - 1))]
    plain = acquire2.corr_surface2_plain(F, code)
    torch.cuda.synchronize()
    idx = [int(g[1][0, 0]) for g in got]
    check(idx == [0, 1], ("k1 tie", W, idx))
    np.testing.assert_allclose(got[0][0].cpu().numpy(),
                               plain[0].cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(got[0][2].cpu().numpy(),
                               plain[2].cpu().numpy(), rtol=1e-4)
    log(f"[k1] planted tie at W={W} ({C} CTAs, {nr} rows a rank): lags 0 "
        f"and {nr} ({'rank 1' if C > 1 else 'the next row'}) reported over "
        f"the tied lags of rank 0 "
        f"(idx {idx[0]} from 0, {idx[1]} from lo {nr - 1})  [{card}]")


def phase_k1(dev, card, results):
    r = _k1_case(dev, card, "gps-l1", 32, 70, 80, 4096, 1234, 5)
    shapes = [r.pop("shape")]
    shapes.append(_k1_case(dev, card, "beidou-b1i", 63, 70, 40, 16384, 4321,
                           8)["shape"])
    # the kernels line keeps the GPS L1 case's numbers (the e2e shape)
    results["acquire2"].update(r)
    errs = [r["max_abs_err"]]
    windows = {4096, 16384}
    for i, name in enumerate(E2E_WIDE):
        route, P, DC, B, W, n_valid = wide_launch(name)
        if route != "v1":
            w = _k1_case(dev, card, name, P, DC, B, W, 50 + i, 60 + i,
                         n_valid, reps=2, plain_reps=1)
            errs.append(w["max_abs_err"])
            shapes.append(w["shape"])
            windows.add(W)
    # e2e_fdma's searches: one code row against every channel's band (the
    # GLONASS L1 and L2 launches are the same shape)
    launch = fdma_launch(E2E_FDMA[0])
    check(all(fdma_launch(name) == launch for name in E2E_FDMA), launch)
    w = _k1_case(dev, card, "glonass-l1/l2 fdma", *launch, 80, 81, reps=3,
                 plain_reps=1)
    errs.append(w["max_abs_err"])
    shapes.append(w["shape"])
    # e2e_workload's 21 acquisitions: each launch shape not held above
    for i, (name, (P, DC, B, W, n_valid)) in enumerate(
            workload_launches().items()):
        if any(k == (P, B, W, n_valid, True) and DC <= d
               for d, k in CHECKED["acquire2"]):
            continue
        w = _k1_case(dev, card, f"workload {name}", P, DC, B, W, 90 + i,
                     95 + i, n_valid, reps=2, plain_reps=1)
        errs.append(w["max_abs_err"])
        shapes.append(w["shape"])
        windows.add(W)
    # e2e_sensitivity's non-coherent search: the run-time core at 8192
    P, DC, B, W, n_valid = sensitivity_launches()[0]
    w = _k1_case(dev, card, "sensitivity beidou-b1i", P, DC, B, W, 120, 121,
                 n_valid, reps=20, plain_reps=3)
    errs.append(w["max_abs_err"])
    shapes.append(w["shape"])
    windows.add(W)
    results["acquire2"]["max_abs_err"] = max(errs)
    results["acquire2"]["shapes"] = shapes
    for W in sorted(windows):
        _k1_tie(dev, card, W)


# ---------------------------------------------------------------- phase k7

def mesh_launch(name, nsat, ntime, ms=80):
    """(route, P, DC, B, W) of the first surface-kernel launch of one
    shard of acquire_signal_sharded on `name` at its default PRNs and
    doppler grid over an nsat x ntime mesh, as parallel/acquire plans it."""
    from gnss_dsp_tpu_torch.acquire import engine
    from gnss_dsp_tpu_torch.acquire.plan import mesh_plan
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.parallel.acquire import mesh_dop_chunk

    sig = get_signal(name)
    route, W = mesh_plan(sig)
    P = -(-len(sig.prns()) // nsat)
    B = -(-engine._block_count(sig, ms) // ntime)
    D = len(engine.doppler_grid(sig, sig.doppler_default)[0])
    return route, P, mesh_dop_chunk(P, W, D), B, W


def fdma_mesh_launch(name, nsat, ntime, ms=80):
    """(route, P, DC, B, W) of the first K1 surface launch of one shard of
    acquire_signal_fdma_sharded on `name` at its default channels and
    grid over an nsat x ntime mesh: one code row against the bands of the
    sat row's ceil(C / nsat) channels."""
    from gnss_dsp_tpu_torch.acquire import engine
    from gnss_dsp_tpu_torch.acquire.plan import mesh_plan
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.parallel.acquire import fdma_dop_chunk

    sig = get_signal(name)
    route, W = mesh_plan(sig)
    B = -(-engine._block_count(sig, ms) // ntime)
    D = len(engine.doppler_grid(sig, sig.doppler_default)[0])
    Dr = -(-len(sig.prns()) // nsat) * D
    return route, 1, fdma_dop_chunk(W, B, Dr), B, W


def _planted_surface(dev, P, DC, B, W, seed, plant_seed):
    """Random code spectra and data spectra F [DC, B, W] with one
    correlation peak per PRN at a random doppler and lag: (code_f, F,
    dopplers, lags)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    code_f = torch.exp(1j * 2 * np.pi * torch.rand(
        (P, W), generator=g, device=dev)).to(torch.complex64)
    F = torch.complex(torch.randn((DC, B, W), generator=g, device=dev),
                      torch.randn((DC, B, W), generator=g, device=dev))
    rng = np.random.default_rng(plant_seed)
    dops = rng.integers(0, DC, P)
    want = rng.integers(0, W, P)           # where each PRN's surface peaks
    k = torch.arange(W, device=dev, dtype=torch.float64)
    for p in range(P):
        ramp = torch.exp(2j * np.pi * k * float(want[p]) / W)
        F[int(dops[p])] += 0.5 * (code_f[p].to(torch.complex128)
                                  * ramp).to(torch.complex64)[None, :]
    return code_f, F, dops, want


def _k7_case(dev, card, tag, P, DC, B, W, seed, plant_seed, clusters,
             reps=3):
    """K7 against its plain version on a planted surface: planted lags
    exact, the surface within rtol 1e-4 plus 2e-5 of its maximum, two
    launches bit-equal; times, plan and the other cluster sizes."""
    import torch

    from gnss_dsp_tpu_torch.ops import acquire

    code_f, F, dops, want = _planted_surface(dev, P, DC, B, W, seed,
                                             plant_seed)
    CHECKED["acquire"].append(shape_key("acquire", F, code_f))
    q_k = acquire.corr_surface(F, code_f)
    q_p = acquire.corr_surface_plain(F, code_f)
    same = torch.equal(q_k, acquire.corr_surface(F, code_f))
    torch.cuda.synchronize()
    check(same, f"k7 {tag}: two launches differ")
    got = q_k.argmax(dim=-1).cpu().numpy()[np.arange(P), dops]
    check((got == want).all(), ("k7 planted lag", tag, got, want))
    scale = float(q_p.max())
    err = float((q_k - q_p).abs().max())
    torch.testing.assert_close(q_k, q_p, rtol=1e-4, atol=2e-5 * scale)
    ms = cuda_ms(lambda: acquire.corr_surface(F, code_f), reps)
    plain_ms = cuda_ms(lambda: acquire.corr_surface_plain(F, code_f), 1)
    lib = library_ms(code_f, F)
    bms, by = surface_bound(P, DC, B, W, P * DC * W * 4)
    cells = P * DC * B * W
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    info = acquire.launch_info(P, DC, B, W, dev.index or 0)
    log(f"[k7] {tag}: P={P} DC={DC} B={B} W={W}: planted lags exact, "
        f"surface within rtol 1e-4 + 2e-5 of its max ({scale:.4g}), "
        f"max|dq| = {err:.3g}, two launches bit-equal")
    log(f"[k7] {tag}: kernel {ms:.3f} ms ({cells / ms / 1e6:.4g} Gcells/s), "
        f"plain {plain_ms:.3f} ms, library ifft {library_text(lib, ms)}, "
        f"bound {bms:.3f} ms by {by}  [{card}]")
    log(f"[k7] {tag}: plan: {info['n1']} x {info['n2']}, "
        f"{plan_text(info, sms)}, {info['nseg']} block segments per (PRN, "
        f"doppler)")
    for c in clusters:
        if c == info["cluster"]:
            continue
        other = acquire.launch_info(P, DC, B, W, dev.index or 0, c)
        q_c = acquire.corr_surface(F, code_f, cluster=c)
        torch.testing.assert_close(q_c, q_p, rtol=1e-4, atol=2e-5 * scale)
        ms_c = cuda_ms(lambda: acquire.corr_surface(F, code_f, cluster=c),
                       reps)
        log(f"[k7] {tag}: ablation, {c} CTAs a cluster: {ms_c:.3f} ms "
            f"against {ms:.3f}; {plan_text(other, sms)}, {other['nseg']} "
            f"segments; surface within rtol 1e-4 of the plain version  "
            f"[{card}]")
    del F, q_k, q_p
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib[0], library_calls=lib[1], bound_ms=bms,
                bound_by=by)


def phase_k7(dev, card, results):
    """K7 at Xona X5's launch shape (the single-card route) and at the
    sharded search's GPS L5I shard shape (61380, mesh_launch on 2 x 2)."""
    route, P, DC, B, W, _ = wide_launch("xona-x5d")
    check(route == "v1", ("xona-x5d route", route))
    results["acquire"].update(_k7_case(dev, card, "xona-x5d", P, DC, B, W,
                                       3069, 9, K7_CLUSTERS[W]))
    route, P, DC, B, W = mesh_launch("gps-l5i", 2, 2)
    check(route == "v1" and W == 61380, ("gps-l5i sharded route", route, W))
    results["acquire_61380"].update(_k7_case(
        dev, card, "gps-l5i 2 x 2 shard", P, DC, B, W, 6138, 10,
        K7_CLUSTERS[W], reps=2))
    # GNSS_DSP_NO_V2P: the pad2 signals' single-card search at 61380
    # (e2e_switches), one doppler chunk of GPS L5I's launch
    from gnss_dsp_tpu_torch.tools.main_path import environ

    with environ({"GNSS_DSP_NO_V2P": "1"}):
        route, P, DC, B, W, _ = wide_launch("gps-l5i")
    check(route == "v1" and W == 61380, ("gps-l5i NO_V2P route", route, W))
    one = _k7_case(dev, card, "gps-l5i single card, GNSS_DSP_NO_V2P", P,
                   DC, B, W, 6139, 11, (), reps=2)
    results["acquire_61380"]["single_card"] = dict(
        shape=f"{P} x {DC} x {B} x {W}", **one)
    results["acquire_61380"]["max_abs_err"] = max(
        results["acquire_61380"]["max_abs_err"], one["max_abs_err"])


# --------------------------------------------------------------- phase k1s

def _k1s_case(dev, card, tag, P, DC, B, W, seed, reps=3):
    """K1's surface (reduce=False) against its plain version on a planted
    surface: planted lags exact, the surface within rtol 1e-4 plus 2e-5 of
    its maximum (K7's tolerance: float32 FFTs in another order), two
    launches bit-equal; its time beside K7's at the same shape (where K7
    takes W) and one library ifft over the product, and its plan."""
    import torch

    from gnss_dsp_tpu_torch.ops import acquire, acquire2

    code_f, F, dops, want = _planted_surface(dev, P, DC, B, W, seed,
                                             seed + 1)
    args = (F, code_f, 0, False)
    CHECKED["acquire2"].append(shape_key("acquire2", *args))
    q_k = acquire2.corr_surface2(*args)
    q_p = acquire2.corr_surface_plain(F, code_f)
    same = torch.equal(q_k, acquire2.corr_surface2(*args))
    torch.cuda.synchronize()
    check(same, f"k1s {tag}: two launches differ")
    got = q_k.argmax(dim=-1).cpu().numpy()[np.arange(P), dops]
    check((got == want).all(), ("k1s planted lag", tag, got, want))
    scale = float(q_p.max())
    err = float((q_k - q_p).abs().max())
    torch.testing.assert_close(q_k, q_p, rtol=1e-4, atol=2e-5 * scale)
    del q_k, q_p
    ms = cuda_ms(lambda: acquire2.corr_surface2(*args), reps)
    plain_ms = cuda_ms(lambda: acquire2.corr_surface_plain(F, code_f), 1)
    try:
        acquire.launch_info(P, DC, B, W, dev.index or 0)
        k7 = f"{cuda_ms(lambda: acquire.corr_surface(F, code_f), reps):.3f} ms"
    except NotImplementedError:
        k7 = "not run (no cluster of up to 8 CTAs holds the row)"
    lib = library_ms(code_f, F)
    bms, by = surface_bound(P, DC, B, W, P * DC * W * 4)
    cells = P * DC * B * W
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    info = acquire2.launch_info(W, dev.index or 0, 0, False)
    log(f"[k1s] {tag}: P={P} DC={DC} B={B} W={W}: planted lags exact, "
        f"surface within rtol 1e-4 + 2e-5 of its max ({scale:.4g}), "
        f"max|dq| = {err:.3g}, two launches bit-equal")
    log(f"[k1s] {tag}: plan: {plan_text(info, sms)}")
    log(f"[k1s] {tag}: kernel {ms:.3f} ms ({cells / ms / 1e6:.4g} "
        f"Gcells/s), K7 at the same shape {k7}, plain {plain_ms:.3f} ms, "
        f"library ifft {library_text(lib, ms)}, bound {bms:.3f} ms by {by}  "
        f"[{card}]")
    del F, args
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib[0], bound_ms=bms, bound_by=by,
                shape=dict(shape=f"{P} x {DC} x {B} x {W}", case=tag, ms=ms,
                           plain_ms=plain_ms, k7=k7, library_ms=lib[0],
                           bound_ms=bms))


def phase_k1s(dev, card, results):
    """K1's surface at every launch shape of e2e_mesh: GPS L1 on one shard
    of the 2 x 2 mesh (the kernels line's case), on the 1 x 1 mesh of
    acquire --mesh 1 and on the 1 x 2 mesh of the two gloo ranks, and GPS
    L2CM on one shard of the 2 x 2 mesh (the run-time core at 163840)."""
    cases = (("gps-l1 2 x 2 shard", "gps-l1", 2, 2),
             ("gps-l1 1 x 1", "gps-l1", 1, 1),
             ("gps-l1 1 x 2 shard", "gps-l1", 1, 2),
             ("gps-l2cm 2 x 2 shard", "gps-l2cm", 2, 2),
             ("glonass-l1 fdma 2 x 2 shard", "glonass-l1", 2, 2))
    shapes, errs = [], []
    for i, (tag, name, nsat, ntime) in enumerate(cases):
        launch = fdma_mesh_launch if "fdma" in tag else mesh_launch
        route, P, DC, B, W = launch(name, nsat, ntime)
        check(route == "v2", (tag, "route", route))
        r = _k1s_case(dev, card, tag, P, DC, B, W, 700 + i)
        shapes.append(r.pop("shape"))
        errs.append(r["max_abs_err"])
        if i == 0:
            results["acquire2_surface"].update(r)
    results["acquire2_surface"]["max_abs_err"] = max(errs)
    results["acquire2_surface"]["shapes"] = shapes


# ----------------------------------------------------------- phases k5, k6

def _planted_code(dev, g, P, W):
    import torch

    return torch.exp(1j * 2 * np.pi * torch.rand(
        (P, W), generator=g, device=dev)).to(torch.complex64)


def _ramp(code_p, lag, W):
    """code_p e^{+2 pi i k lag/W}: against code_p its surface peaks at
    lag."""
    import torch

    k = torch.arange(W, device=code_p.device, dtype=torch.float64)
    return code_p.to(torch.complex128) * torch.exp(2j * np.pi * k * lag / W)


def _check_coh(tag, got, plain, plants, surface):
    """idx and align exact on the planted cells; elsewhere a differing
    (idx, align) only where the plain surface ties at both cells to
    float32 rounding; peak rtol 1e-4.  Returns (max |dpeak|, number of
    near-tie differences)."""
    pk_k, ix_k, al_k = (v.cpu().numpy() for v in got)
    pk_p, ix_p, al_p = (v.cpu().numpy() for v in plain)
    for p, d, a, j in plants:
        check((ix_k[p, d], al_k[p, d]) == (j, a),
              (tag, "planted", p, d, ix_k[p, d], al_k[p, d], j, a))
        check((ix_p[p, d], al_p[p, d]) == (j, a), (tag, "plain planted"))
    np.testing.assert_allclose(pk_k, pk_p, rtol=1e-4)
    diff = np.argwhere((ix_k != ix_p) | (al_k != al_p))
    for p, d in diff:
        q = surface(p, d)                                  # [A, W]
        a = float(q[al_k[p, d], ix_k[p, d]])
        b = float(q[al_p[p, d], ix_p[p, d]])
        check(abs(a - b) <= 1e-5 * b, (tag, "differs", p, d, a, b))
    return float(np.abs(pk_k - pk_p).max()), len(diff)


def coherent_launch(name, m, ms, step):
    """(P, DC, G, A, W, n_valid) of the first (largest) K5 launch of the
    acquire CLI's `name` --coherent m --time ms over -500..500 Hz in
    `step` Hz at its default PRNs, as acquire/coherent.py plans it (per-PRN
    overlays and FDMA channels: one PRN or channel a launch)."""
    from gnss_dsp_tpu_torch.acquire import engine
    from gnss_dsp_tpu_torch.acquire.coherent import coh_dop_chunk
    from gnss_dsp_tpu_torch.acquire.plan import coh_plan
    from gnss_dsp_tpu_torch.models import get_signal

    sig = get_signal(name)
    n = int(round(sig.acq_fs * sig.acq_coherent_ms / 1000.0))
    prns = sig.prns()
    secs = [np.asarray(sig.secondary(p)) if sig.secondary is not None
            else np.ones(1) for p in prns]
    N = len(secs[0])
    # per-PRN overlays and FDMA channels: one PRN (channel) a launch
    per_prn = bool(sig.fdma_hz) or any(
        not np.array_equal(v, secs[0]) for v in secs[1:])
    blocks = max(int(ms / sig.acq_coherent_ms) // m, 1) * m
    fast = coh_plan(sig, n, m, N)
    check(fast is not None and fast[0] == "spec", (name, "not K5", fast))
    D = len(engine.doppler_grid(sig, (-500.0, 500.0, step))[0])
    dc = coh_dop_chunk(fast, len(prns), blocks, m, N, fast[1], D)
    return (1 if per_prn else len(prns)), dc, blocks // m, N, fast[1], fast[3]


def _k5_case(dev, card, tag, P, DC, G, A, W, n_valid, seed, reps=3):
    """K5 against its plain version on [DC, G*A, W] noise rows with one
    planted cell per PRN at a random (doppler, alignment, searched lag)
    and, with n_valid, a stronger one at a lag below lo = W - n_valid in
    the same cell row, which must not win; then at the other cluster
    sizes built.  Returns the numbers."""
    import torch

    from gnss_dsp_tpu_torch.ops import acquire_coh

    g = torch.Generator(device=dev).manual_seed(seed)
    code_f = _planted_code(dev, g, P, W)
    f2 = torch.complex(torch.randn((DC, G * A, W), generator=g, device=dev),
                       torch.randn((DC, G * A, W), generator=g, device=dev))
    rng = np.random.default_rng(seed)
    lo = W - n_valid if n_valid else 0
    dops = rng.permutation(DC)[:P] if P <= DC else rng.integers(0, DC, P)
    plants = [(p, int(dops[p]), int(rng.integers(A)),
               int(rng.integers(W - lo))) for p in range(P)]
    for p, d, a, j in plants:
        f2[d, a::A] += (0.5 * _ramp(code_f[p], lo + j, W)).to(torch.complex64)
        if lo:
            decoy = _ramp(code_f[p], int(rng.integers(lo)), W)
            f2[d, int(rng.integers(A))::A] += decoy.to(torch.complex64)
    args = (f2, code_f, A, n_valid)
    CHECKED["acquire_coh_spec"].append(shape_key("acquire_coh_spec", *args))

    def surface(p, d):
        return acquire_coh.surface_spec_plain(
            f2[d:d + 1], code_f[p:p + 1], A)[0, 0, :, lo:]

    got = acquire_coh.corr_surface_coh_spec(*args)
    plain = acquire_coh.corr_surface_coh_spec_plain(*args)
    again = acquire_coh.corr_surface_coh_spec(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          (tag, "two launches differ"))
    err, nd = _check_coh(f"k5 {tag}", got, plain, plants, surface)
    ms = cuda_ms(lambda: acquire_coh.corr_surface_coh_spec(*args), reps)
    plain_ms = cuda_ms(lambda: acquire_coh.corr_surface_coh_spec_plain(*args),
                       1)
    lib = library_ms(code_f, f2)
    bms, by = surface_bound(P, DC, G * A, W, P * DC * 12)
    cells = P * DC * G * A * W
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    info = acquire_coh.spec_launch_info(W, dev.index or 0)
    log(f"[k5] {tag}: P={P} DC={DC} G={G} A={A} W={W} n_valid={n_valid}: "
        f"idx and align exact on planted cells"
        + (", the stronger cells below lo lost" if lo else "")
        + f", {nd} near-tie differences elsewhere, max|dpeak| = {err:.3g}, "
        f"two launches bit-equal")
    log(f"[k5] {tag}: kernel {ms:.3f} ms ({cells / ms / 1e6:.4g} Gcells/s), "
        f"plain {plain_ms:.3f} ms, library ifft {library_text(lib, ms)}, "
        f"bound {bms:.3f} ms by {by}  [{card}]")
    log(f"[k5] {tag}: plan: {plan_text(info, sms)}")
    if W == acquire_coh.BATCHED_W:
        got_s = acquire_coh.corr_surface_coh_spec(*args, surface_rows=True)
        check(all(torch.equal(a, b) for a, b in zip(got, got_s)),
              (tag, "surface_rows' build differs from the batched core"))
        ms_s = cuda_ms(lambda: acquire_coh.corr_surface_coh_spec(
            *args, surface_rows=True), reps)
        log(f"[k5] {tag}: ablation, surface_rows' build: {ms_s:.3f} ms "
            f"against {ms:.3f}; bit-equal  [{card}]")
    for c in K5_CLUSTERS.get(W, ()):
        other = acquire_coh.spec_launch_info(W, dev.index or 0, c)
        got_c = acquire_coh.corr_surface_coh_spec(*args, cluster=c)
        _check_coh(f"k5 {tag}", got_c, plain, plants, surface)
        ms_c = cuda_ms(lambda: acquire_coh.corr_surface_coh_spec(
            *args, cluster=c), reps)
        log(f"[k5] {tag}: ablation, {c} CTAs a cluster: {ms_c:.3f} ms "
            f"against {ms:.3f}; {plan_text(other, sms)}; planted cells "
            f"exact  [{card}]")
    del f2, args
    torch.cuda.empty_cache()
    shape = dict(shape=f"{P} x {DC} x {G}x{A} rows x {W}" + (
        f", n_valid {n_valid}" if n_valid else ""), signal=tag, ms=ms,
        plain_ms=plain_ms, library_ms=lib[0], library_calls=lib[1],
        bound_ms=bms, k5_over_library=ms / lib[0] if lib[0] else None)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib[0], bound_ms=bms, bound_by=by,
                shape=shape)


def _k5_tie(dev, card, W, G=2, A=3):
    """K5 on rows whose surface ties exactly at every lag with an even row
    index j mod n1 (as _k1_tie: X = delta[0] + delta[(n1/2) n2], every
    product by a unit twiddle or by zero), alignment 0 at half that,
    alignments 1 and 2 equal: from lag 0 the kernel must report lag 0 at
    alignment 1, and from lo = nr - 1 lag nr (rank 1, over rank 0's tied
    lag n1), idx 1, alignment 1."""
    import torch

    from gnss_dsp_tpu_torch.ops import acquire_coh

    _, n1, n2, C = acquire_coh.spec_core_plan(W)
    nr = -(-n1 // C)
    code = torch.ones((1, W), dtype=torch.complex64, device=dev)
    f2 = torch.zeros((1, G * A, W), dtype=torch.complex64, device=dev)
    f2[:, :, 0] = 1.0
    f2[:, :, (n1 // 2) * n2] = 1.0
    f2[:, 0::A] *= 0.5
    got = [acquire_coh.corr_surface_coh_spec(f2, code, A, nv)
           for nv in (0, W - (nr - 1))]
    plain = acquire_coh.corr_surface_coh_spec_plain(f2, code, A)
    torch.cuda.synchronize()
    cells = [(int(g[1][0, 0]), int(g[2][0, 0])) for g in got]
    check(cells == [(0, 1), (1, 1)], ("k5 tie", W, cells))
    np.testing.assert_allclose(got[0][0].cpu().numpy(),
                               plain[0].cpu().numpy(), rtol=1e-4)
    log(f"[k5] planted tie at W={W} ({C} CTAs, {nr} rows a rank, "
        f"alignments 1 and 2 equal): lag 0 and lag {nr} (rank 1) reported "
        f"over rank 0's tied lags, alignment 1 over 2 ((idx, align) "
        f"{cells[0]} from 0, {cells[1]} from lo {nr - 1})  [{card}]")


def phase_k5(dev, card, results):
    # beidou-b1i --coherent 20 --time 40 over 63 PRNs: 40 blocks in G=2
    # groups, A=20 alignments, linear 2n windows, 51 dopplers a launch
    r = _k5_case(dev, card, "beidou-b1i", 63, 51, 2, 20, 16384, 0, 2345)
    shapes = [r.pop("shape")]
    # the kernels line keeps the B1I case's numbers (e2e_coherent's shape)
    results["acquire_coh_spec"].update(r)
    errs = [r["max_abs_err"]]
    from gnss_dsp_tpu_torch.tools.main_path import COHERENT_WIDE

    seen = set()
    for i, (name, m, ms, step, _) in enumerate(COHERENT_WIDE):
        launch = coherent_launch(name, m, ms, step)
        if launch in seen:
            continue
        seen.add(launch)
        w = _k5_case(dev, card, name, *launch, 70 + i, reps=2)
        errs.append(w["max_abs_err"])
        shapes.append(w["shape"])
    # e2e_fdma's --coherent: one channel a launch, one alignment
    w = _k5_case(dev, card, "glonass-l1 fdma --coherent 8",
                 *coherent_launch(*FDMA_COHERENT), 90, reps=3)
    errs.append(w["max_abs_err"])
    shapes.append(w["shape"])
    results["acquire_coh_spec"]["max_abs_err"] = max(errs)
    results["acquire_coh_spec"]["shapes"] = shapes
    for W in sorted({launch[4] for launch in seen} | {16384}):
        _k5_tie(dev, card, W)


def k6_library_ms(F, code_f, cosang, sinang, sec_mat, m_coh, n_valid=0,
                  reps=2):
    """(ms, result) of K6's function in PyTorch calls: the combine by
    torch.matmul ([A, m_coh] x [m_coh, W] a doppler and group), then
    torch.fft.ifft over the [P, DC, G*A, W] products code_f[p] *
    conj(row), abs, the group sum and finalize_max; the weights formed
    outside the timing."""
    import torch

    from gnss_dsp_tpu_torch.ops import acquire_coh

    DC, B, W = F.shape
    P, A, G = code_f.shape[0], sec_mat.shape[0], B // m_coh
    wc = torch.complex(sec_mat[None] * cosang[:, None, :],
                       -sec_mat[None] * sinang[:, None, :])    # [DC, A, B]
    wg = wc.reshape(DC, A, G, m_coh).transpose(1, 2).contiguous()
    Fg = F.reshape(DC, G, m_coh, W)

    def run():
        f2 = torch.matmul(wg, Fg).reshape(DC, G * A, W)
        q = torch.fft.ifft(code_f[:, None, None, :] * torch.conj(f2)[None],
                           dim=-1).abs()
        return acquire_coh.finalize_max(
            q.reshape(P, DC, G, A, W).sum(dim=2), n_valid)

    out = run()
    ms = cuda_ms(run, reps)
    torch.cuda.empty_cache()
    return ms, out


def _k6_case(dev, card, tag, P, DC, B, m_coh, sec, W, seed, ablate=()):
    """K6 against its plain version on noise spectra with one planted cell
    per PRN at a random (doppler, alignment, lag); two launches bit-equal;
    then the same function in PyTorch calls (k6_library_ms), and K6 with
    the alignments a cluster of `ablate`, each bit-equal to the kernel's
    own plan (the merge does not depend on the order).  Returns the
    numbers."""
    import torch

    from gnss_dsp_tpu_torch.ops import acquire_coh

    A = len(sec)
    g = torch.Generator(device=dev).manual_seed(seed)
    code_f = _planted_code(dev, g, P, W)
    F = torch.complex(torch.randn((DC, B, W), generator=g, device=dev),
                      torch.randn((DC, B, W), generator=g, device=dev))
    ang = 2 * np.pi * torch.rand((DC, B), generator=g, device=dev)
    cosang, sinang = torch.cos(ang), torch.sin(ang)
    sec_mat = torch.from_numpy(np.asarray(sec, np.float32)[
        (np.arange(A)[:, None] + np.arange(B)[None, :]) % A]).to(dev)
    rng = np.random.default_rng(seed)
    dops = rng.permutation(DC)[:P]
    plants = [(p, int(dops[p]), int(rng.integers(A)), int(rng.integers(W)))
              for p in range(P)]
    # block m carries sec[a, m] rot[d, m] code: the rotated, overlay-wiped
    # per-block surfaces add coherently at alignment a
    for p, d, a, j in plants:
        rot = torch.exp(1j * ang[d].to(torch.float64))
        F[d] += (0.5 * sec_mat[a].to(torch.float64)[:, None] * rot[:, None]
                 * _ramp(code_f[p], j, W)[None]).to(torch.complex64)
    args = (F, code_f, cosang, sinang, sec_mat, m_coh)
    CHECKED["acquire_coh"].append(shape_key("acquire_coh", *args))

    def surface(p, d):
        return acquire_coh.surface_blk_plain(
            F[d:d + 1], code_f[p:p + 1], cosang[d:d + 1], sinang[d:d + 1],
            sec_mat, m_coh)[0, 0]

    got = acquire_coh.corr_surface_coh(*args)
    plain = acquire_coh.corr_surface_coh_plain(*args)
    again = acquire_coh.corr_surface_coh(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          (tag, "two launches differ"))
    err, nd = _check_coh(f"k6 {tag}", got, plain, plants, surface)
    ms = cuda_ms(lambda: acquire_coh.corr_surface_coh(*args), 3)
    plain_ms = cuda_ms(lambda: acquire_coh.corr_surface_coh_plain(*args), 1)
    lib_ms, lib = k6_library_ms(*args)
    _check_coh(f"k6 {tag} library", lib, plain, plants, surface)
    # the overlay/rotation combine does not depend on the PRN: 8 operations
    # per block value and alignment, then one surface row per group
    G = B // m_coh
    nbytes = (DC * B * W * 8 + P * W * 8 + DC * B * 8 + A * B * 4
              + P * DC * 12)
    comb_ops = DC * A * B * W * 8
    surf_ops = P * DC * A * G * W * row_flops(W)
    bms, by = bound(nbytes, comb_ops + surf_ops)
    # the bound of the design that runs: at A >= 2 the combine's three
    # TF32 products of each value on the tensor cores, then the surface's
    # float32 operations (A = 1: the float32 streaming sum, the bound)
    design_ms = (max(nbytes / HBM_BYTES_PER_S,
                     3 * comb_ops / TF32_FLOP_PER_S
                     + surf_ops / FP32_FLOP_PER_S) * 1e3
                 if A > 1 else bms)
    cells = P * DC * B * A * W
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cluster, a_chunk = acquire_coh.blk_plan(P, DC, A, G, W, sms)
    info = acquire_coh.spec_launch_info(W, dev.index or 0)
    chunks = -(-A // a_chunk)
    log(f"[k6] {tag}: P={P} DC={DC} B={B} m_coh={m_coh} A={A} W={W}: idx "
        f"and align exact on planted cells, {nd} near-tie differences "
        f"elsewhere, max|dpeak| = {err:.3g}, two launches bit-equal; the "
        f"library's result the same on the planted cells")
    log(f"[k6] {tag}: plan: {P * DC * chunks} clusters ({chunks} "
        f"alignment chunks of {a_chunk}) over {DC * G * A} combined rows; "
        f"{plan_text(info, sms)}")
    log(f"[k6] {tag}: kernel {ms:.3f} ms ({cells / ms / 1e6:.4g} "
        f"Gcells/s as block x alignment cells), plain {plain_ms:.3f} ms, "
        f"library (matmul, ifft, abs, group sum, finalize_max) "
        f"{lib_ms:.3f} ms (kernel / library {ms / lib_ms:.3f}), bound "
        f"{bms:.3f} ms by {by}; {K6_DESIGN_BOUND if A > 1 else 'A = 1'}: "
        f"{design_ms:.3f} ms  [{card}]")
    for ch in ablate:
        alt = acquire_coh.corr_surface_coh(*args, a_chunk=ch)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, alt)),
              (tag, "another alignment split differs", ch))
        ms_c = cuda_ms(lambda: acquire_coh.corr_surface_coh(
            *args, a_chunk=ch), 3)
        log(f"[k6] {tag}: ablation, {-(-A // ch)} alignment chunks of {ch}: "
            f"{ms_c:.3f} ms against {ms:.3f}; bit-equal  [{card}]")
    del F, args
    torch.cuda.empty_cache()
    shape = dict(shape=f"{P} x {DC} x {B} (m_coh {m_coh}) x {W}, A {A}",
                 signal=tag, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                 bound_ms=bms, bound_by=by, design_bound_ms=design_ms,
                 cluster=cluster, a_chunk=a_chunk,
                 k6_over_library=ms / lib_ms)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, design_bound_ms=design_ms,
                shape=shape)


def _k6_tie(dev, card, W=4096, G=2, A=5, a_chunk=2):
    """K6 on spectra whose combined rows are K5's tie rows (_k5_tie: X =
    delta[0] + delta[(n1/2) n2], every product by a unit twiddle or by
    zero): one block a group (m_coh 1), no rotation, overlay signs +-1
    but 0.5 for alignment 0, so that alignments 1 .. A-1 tie exactly at
    every lag; with a_chunk 2, alignments 1 and 2 lie in different
    chunks.  From lag 0 the kernel must report lag 0 at alignment 1, and
    from lo = nr - 1 lag nr (rank 1, over rank 0's tied lag n1), idx 1,
    alignment 1: the chunks' merge keeps the lowest lag, then the lowest
    alignment."""
    import torch

    from gnss_dsp_tpu_torch.ops import acquire_coh

    _, n1, n2, C = acquire_coh.spec_core_plan(W)
    nr = -(-n1 // C)
    code = torch.ones((1, W), dtype=torch.complex64, device=dev)
    F = torch.zeros((1, G, W), dtype=torch.complex64, device=dev)
    F[:, :, 0] = 1.0
    F[:, :, (n1 // 2) * n2] = 1.0
    sec = np.where(np.random.default_rng(A).random((A, G)) < 0.5, -1.0, 1.0)
    sec[0] = 0.5
    sec_mat = torch.from_numpy(sec.astype(np.float32)).to(dev)
    one = torch.ones((1, G), device=dev)
    zero = torch.zeros((1, G), device=dev)
    got = [acquire_coh.corr_surface_coh(F, code, one, zero, sec_mat, 1, nv,
                                        a_chunk=a_chunk)
           for nv in (0, W - (nr - 1))]
    plain = acquire_coh.corr_surface_coh_plain(F, code, one, zero, sec_mat, 1)
    torch.cuda.synchronize()
    cells = [(int(g[1][0, 0]), int(g[2][0, 0])) for g in got]
    check(cells == [(0, 1), (1, 1)], ("k6 tie", W, cells))
    np.testing.assert_allclose(got[0][0].cpu().numpy(),
                               plain[0].cpu().numpy(), rtol=1e-4)
    log(f"[k6] planted tie at W={W} ({C} CTAs, {nr} rows a rank, A={A} in "
        f"chunks of {a_chunk}, alignments 1 .. {A - 1} equal): lag 0 and lag "
        f"{nr} (rank 1) reported over rank 0's tied lags, alignment 1 over "
        f"2 (another chunk) ((idx, align) {cells[0]} from 0, {cells[1]} from "
        f"lo {nr - 1})  [{card}]")


def phase_k6(dev, card, results):
    from gnss_dsp_tpu_torch.models import get_signal

    x1p = get_signal("xona-x1p")
    # gps-l1 --coherent 8 --time 80 on a 62.5 Hz grid: 80 blocks in
    # groups of 8, one alignment, 102 dopplers a launch
    r = _k6_case(dev, card, "gps-l1 --coherent 8", 32, 102, 80, 8, [1.0],
                 4096, 77)
    # xona-x1p --coherent 100 --time 200: 2 groups of 100 blocks, 100
    # alignments; the alignment split off, and at 4 chunks
    r2 = _k6_case(dev, card, "xona-x1p --coherent 100", 1, 70, 200, 100,
                  x1p.secondary(x1p.prns()[0]), 4096, 78, ablate=(100, 25))
    # e2e_sensitivity's coherent search: B1I at 8192, m_coh = A = 20, on
    # K5's register core of 8 CTAs in alignment chunks
    P, DC, B, m_coh, sec, W = sensitivity_launches()[1]
    r3 = _k6_case(dev, card, "sensitivity beidou-b1i --coherent 20", P, DC,
                  B, m_coh, sec, W, 79)
    _k6_tie(dev, card)
    _k6_tie(dev, card, W=W)
    # the kernels line keeps the GPS L1 case's numbers (the e2e shape)
    shapes = [r.pop("shape"), r2.pop("shape"), r3.pop("shape")]
    results["acquire_coh"].update(r, max_abs_err=max(r["max_abs_err"],
                                                     r2["max_abs_err"],
                                                     r3["max_abs_err"]),
                                  shapes=shapes,
                                  design_bound=K6_DESIGN_BOUND)


# ---------------------------------------------------------------- phase k2

def phase_k2(dev, card, results):
    import torch

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.main_path import (
        B1I_FS, B1I_PRNS, L5Q_FS, L5Q_PRNS)
    from gnss_dsp_tpu_torch.utils.synth import synth_iq
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import (
        init_state, sigp_from_params, track_scan, track_scan_plain)

    C, NB, fs = 32, 900, 4.096e6
    sig = get_signal("gps-l1")
    rng = np.random.default_rng(3)
    prns = (1 + np.arange(C) % 32).tolist()
    dops = rng.uniform(-4000, 4000, C).round(1)
    phases = rng.uniform(0, 1023, C).round(2)
    n = int(NB * fs * 0.001) + 8192
    code_np = sig.code_table(tuple(prns)).astype(np.int8)
    x = np.zeros(n, np.complex64)
    for k in range(8):
        x += synth_iq(code_np[k].astype(np.float64), sig.chip_rate, fs, n,
                      doppler_hz=float(dops[k]), code_phase=float(phases[k]),
                      cn0_dbhz=None, carrier_ratio=1540.0).astype(np.complex64)
    x += (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64) * 0.1
    params = make_params(sig, fs, coffset=0.0, loop_dwells=(200, 200))
    tail = params.nmax + (-(n + params.nmax)) % 1024
    xd = torch.from_numpy(np.concatenate([x, np.zeros(tail, np.complex64)])
                          ).to(dev)
    tab = torch.from_numpy(code_np).to(dev)

    def st0():
        return init_state(code_p=phases, code_f_off=np.zeros(C),
                          carrier_p=np.zeros(C), carrier_f=dops,
                          ptr=np.zeros(C, np.int32), device=dev)

    def run_kernel():
        return track_scan(xd, n, tab, st0(), params, NB)

    def run_plain():
        st = st0()
        return track_scan_plain(
            xd, torch.full((C,), n, dtype=torch.int32, device=dev), tab, st,
            params, NB, torch.full((C,), 1540.0, device=dev),
            torch.zeros(C, dtype=torch.int32, device=dev),
            sigp_from_params(params, C, dev))

    _, rf_k, ri_k = run_kernel()
    _, rf_p, ri_p = run_plain()
    torch.cuda.synchronize()
    rf_k, ri_k = rf_k.cpu().numpy(), ri_k.cpu().numpy()
    rf_p, ri_p = rf_p.cpu().numpy(), ri_p.cpu().numpy()
    H = 200
    np.testing.assert_array_equal(ri_k[:H], ri_p[:H])
    np.testing.assert_allclose(rf_k[:H], rf_p[:H], rtol=2e-5, atol=2e-4)
    same_rows = int((rf_k == rf_p).all(axis=2).sum())
    dcf = np.abs(rf_k[H:, :, 3] - rf_p[H:, :, 3])
    L = sig.code_length
    dcp = np.abs(rf_k[H:, :, 9] - rf_p[H:, :, 9])
    dcp = np.minimum(dcp, L - dcp)
    check(np.nanmax(dcf) <= 0.5, ("carrier_f drift", np.nanmax(dcf)))
    check(np.nanmax(dcp) <= 0.01, ("code_p drift", np.nanmax(dcp)))
    cf_tail = np.nanmedian(rf_k[-50:, :8, 3], axis=0)
    check(np.abs(cf_tail - dops[:8]).max() < 5.0, cf_tail)
    err = float(np.nanmax(np.abs(rf_k[:H] - rf_p[:H])))
    ms = cuda_ms(run_kernel, 3)
    plain_ms = cuda_ms(run_plain, 1)
    samples = float(ri_k[..., 0].sum())
    bms, by = k2_bound(xd.numel(), tab.numel(), NB * C, samples, "none")
    log(f"[k2] C={C} NB={NB} fs={fs:g}: first {H} blocks rows_i exact, "
        f"rows_f max|d| = {err:.3g}; {same_rows}/{NB * C} rows bit-equal; "
        f"after: max|dcarrier_f| {np.nanmax(dcf):.3g} Hz, "
        f"max|dcode_p| {np.nanmax(dcp):.3g} chip")
    plan, direct_ms, s1_ms = _k2_plan_ablation(
        "bench", (xd, torch.full((C,), n, dtype=torch.int32, device=dev), tab,
                  st0(), params, NB, torch.full((C,), 1540.0, device=dev),
                  torch.zeros(C, dtype=torch.int32, device=dev),
                  sigp_from_params(params, C, dev)), "none", ms, NB)
    log(f"[k2] kernel {ms:.3f} ms ({samples / ms / 1e3:.4g} Msamples/s, "
        f"{ms * 1e3 / NB:.3f} us a block), plain {plain_ms:.3f} ms, bound "
        f"{bms:.4f} ms by {by}  [{card}]")
    CHECKED["track_fused"].append(fused_key("track_fused", xd, n, tab, None,
                                            params))
    results["track_fused"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bms, bound_by=by)
    bench = dict(name="gps-l1 bench", channels=C, fs=fs, coherent=1,
                 blocks=NB, ms=ms, us_a_block=ms * 1e3 / NB,
                 plain_ms=plain_ms, bound_ms=bms, bound_by=by, plan=plan,
                 direct_ms=direct_ms, s1_ms=s1_ms)
    fams = [_k2_family(dev, card, name, C, get_signal(name).acq_fs, 1, 60 + i)
            for i, (name, C) in enumerate(E2E_TRACK)]
    # e2e_coherent_track's shapes (tools/main_path.synth_coherent_track)
    fams.append(_k2_family(dev, card, "beidou-b1i", len(B1I_PRNS), B1I_FS,
                           20, 66))
    fams.append(_k2_family(dev, card, "gps-l5q", len(L5Q_PRNS), L5Q_FS, 20,
                           67))
    # e2e_mesh's shard shapes: the e2e channels over two sat shards (4 a
    # shard at 8.184 MHz) and the coherent B1I ones (3 a shard)
    fams.append(_k2_family(dev, card, "gps-l1", 4, 8.184e6, 1, 68))
    fams.append(_k2_family(dev, card, "beidou-b1i", len(B1I_PRNS) // 2,
                           B1I_FS, 20, 69))
    log("[k2] families " + json.dumps(fams))
    results["track_fused"]["shapes"] = [bench] + fams


def _k2_plan_ablation(tag, args, kind, ms, nb):
    """Logs K2's launch plan at track_scan_fused's arguments `args` (the
    card's view: launch_info) and times the same launch on one CTA a
    channel (S = 1), whose rows and state must equal the plan's bit for
    bit.  Returns (the plan with the card's registers, spills and
    clusters at once, the milliseconds of track_scan_fused on the plan's
    S and on S = 1: the kernel and its state packing, without
    track_scan's checks, which wait for the card)."""
    import torch

    from gnss_dsp_tpu_torch.ops import track_fused

    C, L = args[2].shape
    nmax = args[4].nmax
    plan = track_fused.cluster_plan(C, nmax)
    info = track_fused.launch_info(nmax, plan["cluster"], kind,
                                   L > track_fused.MAX_CODE)
    plan.update(regs=info["regs"], spill_bytes=info["spill_bytes"],
                active=info["active"], threads=info["threads"])
    log(f"[k2] {tag}: plan: cluster of {plan['cluster']} CTAs a channel "
        f"(grid {C * plan['cluster']}), {plan['threads']} threads, window "
        f"{plan['tiles']} tiles of {track_fused.TILE} samples, {plan['tpc']} "
        f"a CTA in {plan['batches']} batch(es), two stages of "
        f"{plan['stage_bytes']} bytes, {plan['smem']} bytes of shared memory "
        f"a CTA, {plan['regs']} registers and {plan['spill_bytes']} local "
        f"bytes a thread, {plan['active']} clusters at once")
    got = track_fused.track_scan_fused(*args)
    one = track_fused.track_scan_fused(*args, cluster=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(one[1], got[1], rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(one[2], got[2], rtol=0, atol=0)
    for a, b in zip(one[0], got[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    s_ms = cuda_ms(lambda: track_fused.track_scan_fused(*args), 3)
    s1_ms = cuda_ms(lambda: track_fused.track_scan_fused(*args, cluster=1),
                    3)
    log(f"[k2] {tag}: ablation, 1 CTA a channel: {s1_ms:.3f} ms "
        f"({s1_ms * 1e3 / nb:.3f} us a block) against {s_ms:.3f} ms "
        f"({s_ms * 1e3 / nb:.3f}) on {plan['cluster']} (both by "
        f"track_scan_fused; through track_scan {ms:.3f}); rows and state "
        f"bit-equal")
    return plan, s_ms, s1_ms


def sample_ops(kind):
    """Operations a sample and channel of the tracking correlators: about
    20 (carrier wipe 6, E/P/L chip phases 6, E/P/L sums 6, the DDS index
    2), plus the subcarrier factor's per lag (a family or K3's "subc" 6,
    K3's "tmboc" with its gate 10)."""
    return 20 + 3 * {"none": 0, "tmboc": 10}.get(kind, 6)


def k2_bound(x_numel, chips, rows, samples, kind):
    """bound() of one K2 launch: the chunk read once (8 bytes a sample),
    the chips the lags touch, the rows written (14 values a block and
    channel); the operations of sample_ops."""
    return bound(x_numel * 8 + chips + rows * 14 * 4,
                 samples * sample_ops(kind))


def _k2_family(dev, card, name, C, fs, coh, seed, seconds=0.3,
               chunk_s=0.15):
    """K2 against its plain version at a main-path shape: C channels of
    `name` at fs with coherent span coh (tools/track_all.scan_inputs: 45
    dB-Hz, each code 2-40 ms before its end, so the long codes wrap in
    the run).  A launch whose chunk ends at chunk_s (every channel
    stalls; when coherent, each channel's chunk ends 150.5 periods after
    its start, half-way through its eighth coherent period), then the
    refill: int rows and state equal, float rows bit-equal.  Then the
    time of one launch over the whole capture, its plain version's, and
    the bound.  Returns the numbers."""
    import torch

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops.track_step import subc_kind
    from gnss_dsp_tpu_torch.tools.track_all import scan_inputs
    from gnss_dsp_tpu_torch.track.engine import track_scan, track_scan_plain

    sig = get_signal(name)
    d = scan_inputs(name, C, fs, seconds, seed, dev, coherent_blocks=coh)
    p = d["params"]
    check(p.fused_scan and p.coh_blocks == coh, (name, "not K2", p))
    extra = (d["ratios"], d["cdf"], d["sigp"], d["overlay"])
    nb = int(seconds * 1000 / (sig.code_period_ms / sig.sub_blocks)) + 2
    st, wraps = d["st"], None
    full = torch.full((C,), d["n"], dtype=torch.int32, device=dev)
    first = (d["st"].ptr + int(150.5 * fs * 1e-3 * sig.code_period_ms)
             if coh > 1 else torch.full_like(full, int(fs * chunk_s)))
    for launch, cl in enumerate((first, full)):
        k = track_scan(d["x"], cl, d["tab"], st, p, nb, *extra)
        pl = track_scan_plain(d["x"], cl, d["tab"], st, p, nb, *extra)
        torch.cuda.synchronize()
        torch.testing.assert_close(k[2], pl[2], rtol=0, atol=0)
        torch.testing.assert_close(k[1], pl[1], rtol=0, atol=0,
                                   equal_nan=True)
        for field, a, b in zip(k[0]._fields, k[0], pl[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0,
                                       msg=f"{name} state {field}")
        stalled = int(k[0].stalled.sum())
        check(stalled == C, (name, launch, "channels stalled", stalled))
        if launch == 0 and coh > 1:
            check(bool((k[0].block % coh != 0).all()),
                  (name, "chunk boundary not mid-period"))
        hit = (k[2][:, :, 2] == sig.code_length).any(0)
        wraps = hit if wraps is None else wraps | hit
        st = k[0]._replace(stalled=torch.zeros_like(k[0].stalled))
    check(bool(wraps.all()), (name, "a channel never crossed its code's end"))
    CHECKED["track_fused"].append(fused_key("track_fused", d["x"], d["n"],
                                            d["tab"], d["st"], p))

    def run_kernel():
        return track_scan(d["x"], d["n"], d["tab"], d["st"], p, nb, *extra)

    ms = cuda_ms(run_kernel, 3)
    plain_ms = cuda_ms(lambda: track_scan_plain(
        d["x"], full, d["tab"], d["st"], p, nb, *extra), 1)
    plan, direct_ms, s1_ms = _k2_plan_ablation(
        name, (d["x"], full, d["tab"], d["st"], p, nb, *extra),
        subc_kind(sig.subcarrier), ms, nb)
    ri = run_kernel()[2][..., 0].to(torch.float64)
    ns = ri.sum(0).cpu().numpy()
    cf = sig.chip_rate / fs
    chips = sum(min(sig.code_length, int(v * cf) + 3) for v in ns)
    bms, by = k2_bound(d["x"].numel(), chips, nb * C, float(ns.sum()),
                       subc_kind(sig.subcarrier))
    rows = int((ri > 0).sum())
    log(f"[k2] {name} ({sig.subcarrier}, sub {sig.sub_blocks}, L "
        f"{sig.code_length}{', M ' + str(coh) if coh > 1 else ''}) C={C} "
        f"fs={fs:g} nmax={p.nmax}: two launches across a stall, rows_i "
        f"and state exact, rows_f bit-equal; {rows} rows in {nb} blocks; "
        f"kernel {ms:.3f} ms ({ns.sum() / ms / 1e3:.4g} Msamples/s, "
        f"{ms * 1e3 / nb:.3f} us a block), plain {plain_ms:.3f} ms, bound "
        f"{bms:.4f} ms by {by}  [{card}]")
    return dict(name=name, channels=C, fs=fs, coherent=coh, blocks=nb,
                rows=rows, max_abs_err=0.0, ms=ms, us_a_block=ms * 1e3 / nb,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, plan=plan,
                direct_ms=direct_ms, s1_ms=s1_ms)


# ---------------------------------------------------------- phase k2, main

def phase_k2_main_path(dev, results, work, seconds=0.8, chunk_s=0.35,
                       nb=(400, 300)):
    """K2 against its plain version at the main path's shape: the e2e
    capture's 8 channels at 8.184 MHz, uploaded as int8 and converted on
    the card, each channel starting at its first code boundary as the
    driver aligns it.  The first chunk ends mid-run, so every channel
    stalls; then the driver's refill (drop consumed samples, rebase the
    pointers) and a second launch.  Loop dwells of 150/150 blocks put the
    FLL -> PLL switch inside the first launch."""
    import torch

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import cplx
    from gnss_dsp_tpu_torch.tools.main_path import synth_capture
    from gnss_dsp_tpu_torch.track.driver import make_params
    from gnss_dsp_tpu_torch.track.engine import (
        init_state, sigp_from_params, track_scan, track_scan_plain)

    fs = 8.184e6
    path = os.path.join(work, "k2_gps_l1.iq")
    truth = synth_capture(path, fs, seconds)
    raw = np.fromfile(path, np.int8)
    os.remove(path)
    sig = get_signal("gps-l1")
    params = make_params(sig, fs, 0.0, loop_dwells=(150, 150))
    L, C = sig.code_length, len(truth["prns"])
    n0 = [int(fs * 0.001 * sig.code_period_ms * (L - cp) / L)
          for cp in truth["phases"]]
    code_p0 = [cp + k * (sig.chip_rate / fs)
               for cp, k in zip(truth["phases"], n0)]
    st = init_state(code_p=np.array(code_p0), code_f_off=np.zeros(C),
                    carrier_p=np.zeros(C), carrier_f=np.array(truth["dops"]),
                    ptr=np.array(n0, np.int32), device=dev)
    tab = torch.from_numpy(sig.code_table(truth["prns"]).astype(np.int8)
                           ).to(dev)
    ratios = torch.tensor([sig.track_carrier_ratio(p) for p in truth["prns"]],
                          dtype=torch.float32, device=dev)
    cdf = torch.full((C,), params.coffset_df_fixed, dtype=torch.int32,
                     device=dev)
    sigp = sigp_from_params(params, C, dev)
    start, err, same, total = 0, 0.0, 0, 0
    for launch, nblk in enumerate(nb):
        nbuf = (int(fs * chunk_s) if launch == 0
                else len(raw) // 2 - start)
        tail = params.nmax + (-(nbuf + params.nmax)) % 1024
        x = cplx.from_int8_iq(raw[2 * start: 2 * (start + nbuf)], pad=tail,
                              device=dev)
        st = st._replace(stalled=torch.zeros_like(st.stalled))
        st_k, rf_k, ri_k = track_scan(x, nbuf, tab, st, params, nblk,
                                      ratios=ratios, coffset_df=cdf,
                                      sigp=sigp)
        st_p, rf_p, ri_p = track_scan_plain(
            x, torch.full((C,), nbuf, dtype=torch.int32, device=dev), tab,
            st, params, nblk, ratios, cdf, sigp)
        torch.cuda.synchronize()
        rf_k, rf_p = rf_k.cpu().numpy(), rf_p.cpu().numpy()
        np.testing.assert_array_equal(ri_k.cpu().numpy(), ri_p.cpu().numpy())
        np.testing.assert_allclose(rf_k, rf_p, rtol=2e-5, atol=2e-4)
        for name, a, b in zip(st_k._fields, st_k, st_p):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-4,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
        valid = ~np.isnan(rf_k).any(axis=2)
        err = max(err, float(np.abs(rf_k - rf_p)[valid].max()))
        same += int(((rf_k == rf_p) | (np.isnan(rf_k) & np.isnan(rf_p))
                     ).all(axis=2).sum())
        total += rf_k.shape[0] * C
        rows = int(valid.sum())
        stalled = int(st_k.stalled.sum())
        if launch == 0:
            check(stalled == C, ("first chunk did not stall every channel",
                                 stalled))
        else:
            check(stalled == 0, ("second launch stalled", stalled))
        st = st_k
        consumed = int(st.ptr.min())
        start += consumed
        st = st._replace(ptr=st.ptr - consumed)
        log(f"[k2] main-path shape, launch {launch}: C={C} fs={fs:g} "
            f"chunk {nbuf} samples, {nblk} blocks, {rows} rows, "
            f"{stalled} channels stalled, rebase by {consumed}")
    log(f"[k2] main-path shape: rows_i and state ints exact, rows_f max|d| "
        f"= {err:.3g}, {same}/{total} rows bit-equal across the stall and "
        f"refill")
    CHECKED["track_fused"].append(fused_key("track_fused", x, nbuf, tab, st,
                                            params))
    r = results["track_fused"]
    r["max_abs_err"] = max(r["max_abs_err"], err)


# ------------------------------------------------------------ phases k3, k4

def step_bound(sig, ns, L, kind):
    """bound() of one per-step correlator launch over blocks of ns
    samples (one per channel): each sample read once (8 bytes), the chips
    the three lags touch, the lanes in and the sums out; the operations
    of sample_ops."""
    chips = sum(min(L, int(n * sig.chip_rate / sig.acq_fs) + 3) for n in ns)
    return bound(sum(ns) * 8 + chips + len(ns) * (36 + 32 + 24) + 8192,
                 sum(ns) * sample_ops(kind))


def _step_case(dev, card, tag, name, C, fs, nb, v1, seed, sub=None,
               dwells=(10, 10), check_rows=False):
    """nb steps of the per-step route on a capture of C channels of `name`
    at fs (45 dB-Hz each), every launch of K3 (or K4 with v1) held against
    the plain version on the same lanes: equal to one float32 ulp of the
    channel's largest sum.  With check_rows the whole scan is held against
    the plain loop too.  Returns the case's numbers."""
    import torch

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import nco, track_step
    from gnss_dsp_tpu_torch.tools import timing
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t
    from gnss_dsp_tpu_torch.track import engine
    from gnss_dsp_tpu_torch.track.driver import make_params

    sig = get_signal(name)
    params = make_params(sig, fs, 0.0, loop_dwells=dwells)._replace(
        fused_scan=False, pallas_v2=not v1)
    sub = sub or (sig.subcarrier if v1 else track_step.subc_kind(sig.subcarrier))
    if v1:
        params = params._replace(subcarrier=sub)
    rng = np.random.default_rng(seed)
    cands = [p for p in sig.prns() if abs(sig.fdma_hz * p) < 0.45 * fs]
    prns = [int(cands[k % len(cands)]) for k in range(C)]
    dops = rng.uniform(-4000, 4000, C).round(1)
    phases = rng.uniform(0, sig.code_length, C).round(2)
    # the first code period's blocks may be 1.5 times the nominal length
    n = int(fs * 0.001 * sig.code_period_ms / sig.sub_blocks * 1.6 * (nb + 2))
    x = torch.zeros(n, dtype=torch.complex64, device=dev)
    for p, d, cp in zip(prns, dops, phases):
        x += synth_iq_t(sig.code_table((p,))[0], sig.chip_rate, fs, n,
                        float(d) + sig.fdma_hz * p, float(cp), sig.subcarrier,
                        sig.track_carrier_ratio(p),
                        code_doppler_hz=float(d), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    sigma = float(np.sqrt(fs / (2.0 * 10 ** 4.5)))
    x += sigma * torch.complex(torch.randn(n, generator=g, device=dev),
                               torch.randn(n, generator=g, device=dev))
    xd = torch.cat([x, torch.zeros(params.nmax + 1024, dtype=x.dtype,
                                   device=dev)])
    tab = torch.from_numpy(sig.code_table(tuple(prns)).astype(np.int8)
                           ).to(dev)
    ratios = torch.tensor([sig.track_carrier_ratio(p) for p in prns],
                          dtype=torch.float32, device=dev)
    cdf = torch.tensor([nco.freq_to_fixed(-sig.fdma_hz * p / fs)
                        for p in prns], dtype=torch.int32, device=dev)
    sigp = engine.sigp_from_params(params, C, dev)
    st0 = engine.init_state(phases, np.zeros(C), np.zeros(C), dops,
                            device=dev)
    cl = torch.full((C,), n, dtype=torch.int32, device=dev)
    kern = engine.kernel_correlate(params)
    stats = dict(n=0, same=0, err=0.0, ns=[])

    def plain(si, sf, x, code):
        return track_step.epl_correlate_plain(si, sf, x, code, params.nmax,
                                              sub, v1=v1)

    def both(si, sf, x, code):
        got = kern(si, sf, x, code)
        want = plain(si, sf, x, code)
        env = want.abs().amax(dim=1, keepdim=True)
        ulp = torch.nextafter(env, torch.full_like(env, np.inf)) - env
        d = (got - want).abs()
        check(bool((d <= ulp).all()), (tag, "kernel vs plain",
                                       float(d.max()), float(ulp.min())))
        stats["n"] += 1
        stats["same"] += int(torch.equal(got, want))
        stats["err"] = max(stats["err"], float(d.max()))
        stats.update(si=si, sf=sf)
        return got

    st, rf, ri = engine._scan(xd, cl, tab, st0, params, nb, ratios, cdf,
                              sigp, both)
    torch.cuda.synchronize()
    ri = ri.cpu().numpy()
    check((ri[:, :, 0] > 0).all(), (tag, "a block did not run"))
    if check_rows:
        _, rf_p, ri_p = engine.track_scan_plain(xd, cl, tab, st0, params,
                                                nb, ratios, cdf, sigp)
        H = min(200, nb)
        rf, rf_p = rf.cpu().numpy(), rf_p.cpu().numpy()
        np.testing.assert_array_equal(ri[:H], ri_p.cpu().numpy()[:H])
        np.testing.assert_allclose(rf[:H], rf_p[:H], rtol=2e-5, atol=2e-4)
        stats["rows_same"] = int((rf == rf_p).all(axis=2).sum())
    kernel = "track_step_v1" if v1 else "track_step_v2"
    key = step_key(kernel, stats["si"], stats["sf"], xd, tab, params.nmax,
                   sub)
    CHECKED[kernel].append(key)
    si, sf = stats["si"], stats["sf"]
    call = lambda: kern(si, sf, xd, tab)
    floor_call = lambda: track_step.launch_floor(C, dev)
    # what a call launches, from a CUDA graph captured from one call (no
    # profiler): one node, the step kernel
    nodes = timing.graph_nodes(call)
    check(len(nodes) == 1 and "step_kernel" in nodes[0][1],
          (tag, name, "not one kernel a call in its CUDA graph", nodes))
    # device time a launch and the floor's (an empty kernel on the same
    # grid, cluster and shared memory): torch.profiler's events where its
    # trace kept at least KEPT_SHARE of them a call, else CUDA events
    # around replays of a graph of 50 calls, which are logged beside them
    # (the call itself is host-bound: CUDA events over eager calls time
    # the wrapper, logged as the call time)
    prof = timing.profiled_kernels(call, 50)
    check(all("step_kernel" in k for k in prof), (tag, name, "a kernel "
                                                  "besides the step kernel",
                                                  prof))
    floor_prof = timing.profiled_kernels(floor_call, 50)
    graph = timing.graph_ms(call, 50, 5)
    floor_graph = timing.graph_ms(floor_call, 50, 5)
    kept, prof_ms = _kept(prof)
    floor_kept, floor_prof_ms = _kept(floor_prof)
    ms = prof_ms if kept >= timing.KEPT_SHARE else graph
    floor_ms = (floor_prof_ms if floor_kept >= timing.KEPT_SHARE
                else floor_graph)
    plain_ms = device_ms(lambda: plain(si, sf, xd, tab), 5)
    call_ms = cuda_ms(call, 50)
    ns = si[:, 4].cpu().numpy().tolist()
    bms, by = step_bound(sig, ns, sig.code_length, sub)
    plan = track_step.step_plan(C)
    info = track_step.launch_info(plan["cluster"], sub, v1, sig.code_length)
    check(info["cluster"] == plan["cluster"], (tag, "plan", info, plan))
    log(f"[{tag}] {name}: plan: S={plan['cluster']} CTAs a channel, "
        f"{plan['ctas']} CTAs, {info['smem']} B shared memory, "
        f"{info['threads']} threads, {info['regs']} registers, "
        f"{info['spill_bytes']} local bytes, {info['active']} clusters at "
        f"once")
    log(f"[{tag}] {name}: CUDA graph of one call: {nodes[0][0]} "
        f"{nodes[0][1]}")
    for what, p, g, k in (("kernel", prof, graph, kept),
                          ("launch floor", floor_prof, floor_graph,
                           floor_kept)):
        log(f"[{tag}] {name}: {what}: profiler " + ("; ".join(
            f"{n}: {t * 1e3:.3f} us a launch over {c:g} events a call kept"
            for n, (c, t) in p.items()) or "saw no event in three tries")
            + f"; graph of 50 calls {g * 1e3:.3f} us a call; taken: "
            + ("profiler" if k >= timing.KEPT_SHARE else
               f"graph (profiler kept {k:g} < {timing.KEPT_SHARE})"))
    log(f"[{tag}] {name}: launch floor {floor_ms * 1e3:.3f} us (an empty "
        f"kernel on the same grid, cluster and shared memory)")
    log(f"[{tag}] {name} {sub} C={C} fs={fs:g} nmax={params.nmax} "
        f"L={sig.code_length}: {stats['n']} launches within one ulp of the "
        f"plain version, {stats['same']} bit-equal, max|d| = "
        f"{stats['err']:.3g}"
        + (f"; {stats['rows_same']}/{nb * C} scan rows bit-equal"
           if check_rows else ""))
    log(f"[{tag}] {name}: kernel {ms * 1e3:.2f} us of device time a launch "
        f"({sum(ns) / ms / 1e3:.4g} Msamples/s; {call_ms * 1e3:.1f} us a "
        f"call from Python), plain {plain_ms * 1e3:.1f} us of device time, "
        f"bound {bms * 1e3:.3f} us by {by}  [{card}]")
    return dict(max_abs_err=stats["err"], ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, floor_ms=floor_ms,
                shape=dict(name=name, sub=sub, C=C, fs=fs, nmax=params.nmax,
                           cluster=plan["cluster"], ms=ms, floor_ms=floor_ms,
                           graph_ms=graph, floor_graph_ms=floor_graph,
                           kept=kept, floor_kept=floor_kept, bound_ms=bms))


def _kept(kernels):
    """(events kept a call, mean device ms a launch) of the one kernel of
    profiled_kernels' dict; (0, None) where the profiler saw none."""
    if len(kernels) != 1:
        return 0.0, None
    return next(iter(kernels.values()))


def _step_results(cases):
    """The kernels line's entry of K3 or K4: the bench case's numbers
    (the first), the largest error of all, and every case's shape and
    times."""
    r = {k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "floor_ms")}
    return dict(r, max_abs_err=max(c["max_abs_err"] for c in cases),
                shapes=[c["shape"] for c in cases])


def phase_k3(dev, card, results):
    """K3 at the tracking bench shape (32 GPS L1 channels, 900 blocks at
    4.096 MHz, the whole scan against the plain loop as in k2), at the
    GPS L1 e2e shape and at every e2e_track shape."""
    from gnss_dsp_tpu_torch.models import get_signal

    cases = [_step_case(dev, card, "k3", "gps-l1", 32, 4.096e6, 900, False,
                        31, dwells=(200, 200), check_rows=True),
             _step_case(dev, card, "k3", "gps-l1", 8, 8.184e6, 40, False, 32)]
    for i, (name, C) in enumerate(E2E_TRACK):
        cases.append(_step_case(dev, card, "k3", name, C,
                                get_signal(name).acq_fs, 40, False, 33 + i))
    results["track_step_v2"].update(_step_results(cases))


def phase_k4(dev, card, results):
    """K4 for all six families, each at the e2e shape of a signal that
    carries it (GPS L1 at 8.184 MHz, the others 8 channels at acq_fs), and
    at the tracking bench shape for the kernels line."""
    from gnss_dsp_tpu_torch.models import get_signal

    cases = [_step_case(dev, card, "k4", "gps-l1", 32, 4.096e6, 100, True,
                        41, dwells=(200, 200))]
    for i, (family, name) in enumerate(K4_FAMILIES):
        fs = 8.184e6 if name == "gps-l1" else get_signal(name).acq_fs
        cases.append(_step_case(dev, card, "k4", name, 8, fs, 40, True,
                                42 + i, sub=family))
    results["track_step_v1"].update(_step_results(cases))


# -------------------------------------------------------- phase track_rows

def _median_ms(fn, n):
    """The median host-clock time of n calls of fn, each started on an
    idle card."""
    import torch

    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phase_track_rows(dev, card, results, C=10, seconds=2.0, nb=2000,
                     reps=20):
    """The rows kernel at gps-l1.track's scan (the cell's 10 GPS L1
    channels at 69.984 MHz, its 2000 ms chunk): the rows of one K2 scan
    written by emit_rows with a RowText on the card equal byte for byte
    to the row-by-row path's (format_row_14 a row), with its counters and
    return value; rows_text's head and text equal to rows_rowwise's.
    Times: the kernel (its four launches, device time), the bulk path a
    scan and the row-by-row path (host clock, text to a StringIO); the
    bound: the rows read and the text written once."""
    import torch

    from gnss_dsp_tpu_torch.ops import track_rows
    from gnss_dsp_tpu_torch.tools.track_all import scan_inputs
    from gnss_dsp_tpu_torch.track import driver
    from gnss_dsp_tpu_torch.track.engine import track_scan
    from gnss_dsp_tpu_torch.track.rows import RowText, format_row_14

    fs = 69.984e6
    d = scan_inputs("gps-l1", C, fs, seconds, 71, dev, dwells=(500, 500))
    _st, rf, ri = track_scan(d["x"], d["n"], d["tab"], d["st"], d["params"],
                             nb, ratios=d["ratios"], coffset_df=d["cdf"],
                             sigp=d["sigp"], overlay=d["overlay"])
    prefixes = [f"ch{p} " for p in d["truth"]["prns"]]
    del d
    torch.cuda.synchronize()
    check(rf.device.type == "cuda", rf.device)
    # the counters of a later chunk of the 7.9 min recording: samp past
    # 2^31
    start = [[30_000_000_000 + 7 * k, 29_000_000 + k, 46_000_000_000 + k]
             for k in range(C)]

    def channels():
        chans = [driver.TrackChannel(prn=0, doppler=0.0, code_offset=0.0)
                 for _ in range(C)]
        for ch, (samp, code_cyc, carrier_cyc) in zip(chans, start):
            ch.samp, ch.code_cyc, ch.carrier_cyc = samp, code_cyc, carrier_cyc
        return chans

    def counters(chans):
        return [[c.samp, c.code_cyc, c.carrier_cyc] for c in chans]

    def rowwise():
        chans, lines = channels(), []
        any_row = driver.emit_rows(
            chans, C, lambda k, row: lines.append(
                prefixes[k] + format_row_14(row) + "\n"), rf, ri, nb)
        return any_row, counters(chans), "".join(lines)

    writer = RowText(prefixes, [14] * C, dev)

    def bulk():
        chans, buf = channels(), io.StringIO()
        with contextlib.redirect_stdout(buf):
            any_row = driver.emit_rows(chans, C, writer, rf, ri, nb)
        return any_row, counters(chans), buf.getvalue()

    want = rowwise()
    lines = want[2].count("\n")
    idle = int((ri[:nb, :, 0] == 0).sum())
    check(lines + idle == nb * C and lines >= 0.99 * nb * C,
          ("track_rows", "rows", lines, idle))
    track_rows.LAUNCHES = 0
    got = bulk()
    check(got[2] == want[2], ("track_rows", "text differs from the "
                              "row-by-row path", len(got[2]), len(want[2])))
    check(got[:2] == want[:2], ("track_rows", "return value or counters "
                                "differ", got[:2], want[:2]))
    check(track_rows.LAUNCHES == 1, ("track_rows", "launches",
                                     track_rows.LAUNCHES))
    pre = torch.tensor(list("".join(prefixes).encode()), dtype=torch.uint8)
    off = torch.tensor(np.cumsum([0] + [len(p) for p in prefixes]),
                       dtype=torch.int32)
    args_d = (rf, ri, nb, C, pre.to(dev), off.to(dev),
              torch.ones(C, dtype=torch.int32, device=dev),
              torch.tensor(start, dtype=torch.int64, device=dev))
    hk, tk = track_rows.rows_text(*args_d)
    hk = hk.cpu().numpy()
    text = bytes(tk[:int(hk[0])].cpu().numpy())
    r_text, r_lines, r_any, r_final = rows_rowwise(*args_d)
    check(text == r_text == want[2].encode("ascii"),
          ("track_rows", "rows_text's bytes differ"))
    check(hk[:4].tolist() == [len(text), r_lines, int(r_any), 0]
          and hk[4:].reshape(C, 3).tolist() == r_final,
          ("track_rows", "head differs from the row-by-row path's",
           hk[:4].tolist(), r_lines))
    CHECKED["track_rows"].append(rows_key("track_rows", *args_d))
    ms = device_ms(lambda: track_rows.rows_text(*args_d), reps)
    bulk_ms = _median_ms(bulk, reps)
    rowwise_ms = _median_ms(rowwise, 3)
    bms, by = bound(rf[:nb].numel() * 4 + ri[:nb].numel() * 4 + len(text)
                    + C * 3 * 8 * 2, 0)
    log(f"[track_rows] gps-l1.track's scan, {C} ch x {nb} blocks at "
        f"{fs:g} Hz: {lines} rows ({idle} idle), {len(text)} bytes; the "
        f"card's text byte-equal to the row-by-row path's, counters, return "
        f"value and head equal")
    log(f"[track_rows] kernel {ms:.4f} ms (four launches), bound {bms:.5f} "
        f"ms by {by}; a scan on the host clock: bulk path on the card "
        f"{bulk_ms:.3f} ms, the row-by-row path {rowwise_ms:.3f} ms (text "
        f"to a StringIO)  [{card}]")
    results["track_rows"].update(
        max_abs_err=0.0, ms=ms, plain_ms=rowwise_ms, bound_ms=bms,
        bound_by=by, bulk_ms=bulk_ms,
        shape=dict(name="gps-l1.track scan", channels=C, fs=fs, blocks=nb,
                   rows=lines, text_bytes=len(text)))


# --------------------------------------------------------------- phase e2e

def phase_e2e(dev, card, results, work, seconds=2.2, nblocks=2150):
    import torch

    import gnss_dsp_tpu_torch.cli.cn0 as cn0
    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.ops import acquire2, track_fused, track_rows
    from gnss_dsp_tpu_torch.tools.main_path import (
        parse_hits, run_cli, synth_capture)

    fs = 8.184e6
    path = os.path.join(work, "e2e_gps_l1.iq")
    t0 = time.perf_counter()
    truth = synth_capture(path, fs, seconds)
    t_synth = time.perf_counter() - t0
    log(f"[e2e] capture {seconds} s at {fs:g} Hz, 8 PRNs at 45 dB-Hz, "
        f"int8 clip fraction {truth['clip']:.2e} ({t_synth:.1f} s)")

    acquire2.LAUNCHES = 0
    track_fused.LAUNCHES = 0
    track_rows.LAUNCHES = 0
    t0 = time.perf_counter()
    with recording() as calls:
        out = run_cli(acq_cli.main, "gps-l1",
                      [path, str(fs), "0", "--device", str(dev)])
    torch.cuda.synchronize()
    t_acq = time.perf_counter() - t0
    check_covered("e2e", calls)
    hits = parse_hits(out)
    check(sorted(hits) == list(range(1, 33)), out)
    absent = max(h["metric"] for p, h in hits.items()
                 if p not in truth["prns"])
    specs = []
    for prn, dop, cp in zip(truth["prns"], truth["dops"], truth["phases"]):
        h = hits[prn]
        dc = abs(h["code"] - cp)
        dc = min(dc, 1023 - dc)
        check(abs(h["doppler"] - dop) <= 200.0, (prn, h, dop))
        check(dc <= 1.0, (prn, h, cp))
        check(h["metric"] > absent, (prn, h, absent))
        specs.append(f"{prn}:{h['doppler']}:{h['code']}")
        log(f"[e2e] acquire prn {prn:2d}: doppler {h['doppler']:7.1f} "
            f"(truth {dop:7.1f}) code {h['code']:6.1f} (truth {cp:7.2f}) "
            f"metric {h['metric']:.2f}")
    log(f"[e2e] best absent-PRN metric {absent:.2f}; acquire "
        f"{t_acq:.2f} s")

    t0 = time.perf_counter()
    with recording() as calls:
        out = run_cli(trk_cli.main, "gps-l1",
                      ["--blocks", str(nblocks), "--device", str(dev), path,
                       str(fs), "0", ",".join(specs)])
    torch.cuda.synchronize()
    t_trk = time.perf_counter() - t0
    check_covered("e2e", calls)
    rows = {p: [] for p in truth["prns"]}
    for line in out.splitlines():
        tag, rest = line.split(" ", 1)
        rows[int(tag[2:])].append(rest)
    t_cn0 = 0.0
    for prn, dop in zip(truth["prns"], truth["dops"]):
        r = rows[prn]
        # --blocks counts scan steps, as in the reference driver: a
        # channel that stalls for a step at the chunk end emits one row
        # fewer; its rows still run on past the refill
        last = int(r[-1].split()[0])
        check(nblocks - 4 <= len(r) <= nblocks and last == len(r) - 1,
              (prn, len(r), last))
        cf = np.array([float(v.split()[3]) for v in r[-200:]])
        check(np.abs(cf - dop).max() <= 5.0, (prn, np.abs(cf - dop).max()))
        t1 = time.perf_counter()
        est = run_cli(cn0.main, ["--time", "500"],
                      stdin_text="\n".join(r[-500:]) + "\n").split()
        t_cn0 += time.perf_counter() - t1
        check(len(est) == 1, est)
        c = float(est[0])
        check(41.0 <= c <= 47.0, (prn, c))
        log(f"[e2e] track prn {prn:2d}: last-200 |carrier_f - truth| <= "
            f"{np.abs(cf - dop).max():.3f} Hz, C/N0 {c:.2f} dB-Hz")
    la, lt, lr = acquire2.LAUNCHES, track_fused.LAUNCHES, track_rows.LAUNCHES
    log(f"[e2e] launches on the main path: acquire2 {la}, track_fused {lt}, "
        f"track_rows {lr}")
    check(la > 0 and lt > 0, (la, lt))
    check(lt >= 2, "tracking never crossed a chunk refill")
    # a scan's rows, a K2 launch's, go through the rows kernel at once
    check(lr == lt, ("track_rows launches", lr, lt))
    results["acquire2"]["launches"] = la
    results["track_fused"]["launches"] = lt
    results["track_rows"]["launches"] = lr
    log(f"[e2e] wall: synth {t_synth:.2f} s, acquire {t_acq:.2f} s, "
        f"track {nblocks} blocks x 8 ch {t_trk:.2f} s, cn0 {t_cn0:.2f} s  "
        f"[{card}]")
    return path, fs, ",".join(specs), out, truth


# ---------------------------------------------------------- phase e2e_track

def _check_track(tag, name, r):
    """run_signal's lock check, and C/N0 of the last 500 rows 41-47
    dB-Hz (3 dB less for the RZ codes, whose chips are zero half the
    time)."""
    from gnss_dsp_tpu_torch.models import get_signal

    sig = get_signal(name)
    check(not r["bad"], (tag, name, "out of lock", r["bad"]))
    lo = 41.0 - (3.0 if sig.subcarrier.startswith("rz") else 0.0)
    for prn, df, c in zip(r["truth"]["prns"], r["max_df"], r["cn0"]):
        check(lo <= c <= lo + 6.0, (tag, name, prn, "C/N0", c))
        log(f"[{tag}] {name} {'chan' if sig.fdma_hz else 'prn'} "
            f"{prn:3d}: {len(r['rows'][prn])} rows, last-200 "
            f"|carrier_f - truth| <= {df:.3f} Hz, C/N0 {c:.2f} dB-Hz")


def phase_e2e_track(dev, card, work):
    """The track CLI on one 2.2 s capture per family of E2E_TRACK
    (tools/track_all.synth_track: 45 dB-Hz, acq_fs), default loop dwells,
    on K2 (K3 and K4 launch no time): every channel within 5 Hz of its
    doppler over the last 200 rows, and C/N0 as _check_track.  Then
    galileo-e1b's capture once more under GNSS_DSP_NO_FUSED, on the
    per-step route (K3; K2 launches no time), with the same checks.
    Returns (K2 launches by family, K3 launches)."""
    import torch

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import track_fused, track_step
    from gnss_dsp_tpu_torch.tools.main_path import environ
    from gnss_dsp_tpu_torch.tools.track_all import run_signal

    def run(name, C, seed):
        track_step.LAUNCHES_V2 = track_step.LAUNCHES_V1 = 0
        track_fused.LAUNCHES = 0
        with recording() as calls:
            r = run_signal(name, str(dev), work, seconds=2.2, count=C,
                           seed=seed, tail=200, cn0_rows=500)
        torch.cuda.synchronize()
        check_covered("e2e_track", calls)
        return r, (track_fused.LAUNCHES, track_step.LAUNCHES_V2,
                   track_step.LAUNCHES_V1)

    k2, walls = {}, {}
    for i, (name, C) in enumerate(E2E_TRACK):
        sig = get_signal(name)
        r, launches = run(name, C, 40 + i)
        check(launches[0] > 0 and launches[1:] == (0, 0),
              (name, "K2 not the route", launches))
        k2[name] = launches[0]
        walls[name] = r["wall_s"]
        _check_track("e2e_track", name, r)
        log(f"[e2e_track] {name} ({sig.subcarrier}, sub {sig.sub_blocks}, L "
            f"{sig.code_length}) {C} ch at {r['truth']['fs']:g} Hz: track CLI "
            f"{r['wall_s']:.2f} s, K2 launches {launches[0]}  [{card}]")
    # the per-step route end to end, on the galileo-e1b capture again
    with environ({"GNSS_DSP_NO_FUSED": "1"}):
        r, launches = run("galileo-e1b", 8, 40)
    check(launches[0] == 0 and launches[1] > 0 and launches[2] == 0,
          ("galileo-e1b", "K3 not the route", launches))
    _check_track("e2e_track", "galileo-e1b", r)
    log(f"[e2e_track] galileo-e1b under GNSS_DSP_NO_FUSED: track CLI "
        f"{r['wall_s']:.2f} s on K3 ({launches[1]} launches) against "
        f"{walls['galileo-e1b']:.2f} s on K2  [{card}]")
    return k2, launches[1]


# ------------------------------------------------------- phase gps_l1_routes

def _rows_by_prn(text):
    rows = {}
    for line in text.splitlines():
        tag, rest = line.split(" ", 1)
        rows.setdefault(int(tag[2:]), []).append(rest)
    return rows


def phase_gps_l1_routes(dev, card, results, e2e):
    """The e2e GPS L1 capture tracked again through the track CLI on the
    per-step route, K3 (GNSS_DSP_NO_FUSED=1) and K4 (and
    GNSS_DSP_PALLAS_V1=1), against the K2 rows of phase e2e: int columns
    identical and floats within rtol 2e-5 / atol 2e-4 over the first 200
    blocks, every channel within 5 Hz of its doppler over the last 200."""
    import torch

    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.ops import track_fused, track_step
    from gnss_dsp_tpu_torch.tools.main_path import environ, run_cli

    path, fs, specs, k2_out, truth = e2e
    want = _rows_by_prn(k2_out)
    for label, env, kernel in (
            ("K3", {"GNSS_DSP_NO_FUSED": "1"}, "track_step_v2"),
            ("K4", {"GNSS_DSP_NO_FUSED": "1", "GNSS_DSP_PALLAS_V1": "1"},
             "track_step_v1")):
        track_step.LAUNCHES_V2 = track_step.LAUNCHES_V1 = 0
        track_fused.LAUNCHES = 0
        with environ(env):
            t0 = time.perf_counter()
            with recording() as calls:
                out = run_cli(trk_cli.main, "gps-l1",
                              ["--blocks", "2150", "--device", str(dev), path,
                               str(fs), "0", specs])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n_v2, n_v1 = track_step.LAUNCHES_V2, track_step.LAUNCHES_V1
        launches = n_v2 if label == "K3" else n_v1
        check(launches > 0 and track_fused.LAUNCHES == 0
              and (n_v1 if label == "K3" else n_v2) == 0,
              (label, "not the route", n_v2, n_v1, track_fused.LAUNCHES))
        results[kernel]["launches"] += launches
        check_covered("gps_l1_routes", calls)
        got = _rows_by_prn(out)
        check(sorted(got) == sorted(want), (label, sorted(got)))
        same = total = 0
        ints = [0, 9, 11, 13]          # block, code_cyc, carrier_cyc, samp
        for prn, dop in zip(truth["prns"], truth["dops"]):
            a = np.array([[float(v) for v in r.split()] for r in want[prn]])
            b = np.array([[float(v) for v in r.split()] for r in got[prn]])
            check(a.shape == b.shape, (label, prn, a.shape, b.shape))
            H = 200
            np.testing.assert_array_equal(b[:H, ints], a[:H, ints])
            fl = [c for c in range(14) if c not in ints]
            np.testing.assert_allclose(b[:H, fl], a[:H, fl], rtol=2e-5,
                                       atol=2e-4 + 1e-6)
            same += sum(x == y for x, y in zip(want[prn], got[prn]))
            total += len(got[prn])
            df = np.abs(b[-200:, 3] - dop).max()
            check(df <= 5.0, (label, prn, "out of lock", df))
        log(f"[gps_l1_routes] {label}: {launches} launches, first 200 blocks "
            f"int columns identical and floats within rtol 2e-5 of K2; "
            f"{same}/{total} text rows identical to K2's; every channel in "
            f"lock; track CLI {wall:.2f} s  [{card}]")


# ------------------------------------------------------ phase e2e_coherent

def check_hits(tag, hits, truth, dop_tol, code_tol=1.0,
               phase="e2e_coherent"):
    """Every planted PRN within dop_tol Hz and code_tol chips of truth,
    and above every absent PRN's metric (where any PRN is absent)."""
    absent = max((h["metric"] for p, h in hits.items()
                  if p not in truth["prns"]), default=None)
    L = truth["code_length"]
    for prn, dop, cp in zip(truth["prns"], truth["dops"], truth["phases"]):
        h = hits[prn]
        dc = abs(h["code"] - cp) % L
        dc = min(dc, L - dc)
        check(abs(h["doppler"] - dop) <= dop_tol, (tag, prn, h, dop))
        check(dc <= code_tol, (tag, prn, h, cp))
        check(absent is None or h["metric"] > absent, (tag, prn, h, absent))
        log(f"[{phase}] {tag} prn {prn:2d}: doppler "
            f"{h['doppler']:7.1f} (truth {dop:7.1f}) code {h['code']:8.2f} "
            f"(truth {cp:8.2f}) metric {h['metric']:.2f}")
    log(f"[{phase}] {tag}: best absent-PRN metric "
        f"{'none (no PRN absent)' if absent is None else f'{absent:.2f}'}")


def phase_e2e_coherent(dev, card, results, work):
    import torch

    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.ops import acquire_coh
    from gnss_dsp_tpu_torch.tools.main_path import (
        B1I_COHERENT, B1I_FS, parse_hits, returns_of, run_cli, synth_at_acq_fs,
        synth_b1i, synth_capture)

    fs = B1I_FS
    b1i = os.path.join(work, "e2e_beidou_b1i.iq")
    t0 = time.perf_counter()
    truth = synth_b1i(b1i, fs, 0.050)
    t_synth = time.perf_counter() - t0
    l1 = os.path.join(work, "e2e_coherent_gps_l1.iq")
    l1_truth = synth_capture(l1, 8.184e6, 0.2)
    l1_truth["code_length"] = 1023

    acquire_coh.LAUNCHES_SPEC = 0
    acquire_coh.LAUNCHES_BLK = 0
    calls = []
    t0 = time.perf_counter()
    with recording() as c:
        out = run_cli(acq_cli.main, "beidou-b1i",
                      B1I_COHERENT + [b1i, str(fs), "0", "--device",
                                      str(dev)])
    calls += c
    torch.cuda.synchronize()
    t_b1i = time.perf_counter() - t0
    hits = parse_hits(out)
    check(sorted(hits) == list(range(1, 64)), out)
    check_hits("beidou-b1i --coherent 20", hits, truth, 25.0)
    t0 = time.perf_counter()
    with recording() as c:
        out = run_cli(acq_cli.main, "gps-l1",
                      ["--coherent", "8", "--time", "80", "--doppler-search",
                       "-6000,6000,62.5", l1, "8184000", "0", "--device",
                       str(dev)])
    calls += c
    torch.cuda.synchronize()
    t_l1 = time.perf_counter() - t0
    hits = parse_hits(out)
    check(sorted(hits) == list(range(1, 33)), out)
    check_hits("gps-l1 --coherent 8", hits, l1_truth, 62.5)
    # Xona X1P: one PRN with a 100-chip overlay, K6 at A = 100.  The code
    # phase lies in the code's first 5%, so block m (a circular window)
    # lies mostly in code period m, which carries chip (roll + m) mod 100:
    # the truth's alignment is the roll
    x1p = os.path.join(work, "e2e_coherent_xona_x1p.iq")
    x1p_truth = synth_at_acq_fs(x1p, "xona-x1p", 0.206, seed=40, count=1,
                                dop_max=450.0, overlay=True,
                                phase_max=0.05 * 1023)
    n6 = acquire_coh.LAUNCHES_BLK
    t0 = time.perf_counter()
    with recording() as c, \
            returns_of(acq_cli, "acquire_signal_coherent") as res:
        out = run_cli(acq_cli.main, "xona-x1p",
                      ["--coherent", "100", "--time", "200",
                       "--doppler-search", "-500,500,5", x1p,
                       str(x1p_truth["fs"]), "0", "--device", str(dev)])
    calls += c
    torch.cuda.synchronize()
    t_x1p = time.perf_counter() - t0
    hits = parse_hits(out)
    check(sorted(hits) == [0], out)
    check_hits("xona-x1p --coherent 100", hits, x1p_truth, 5.0)
    got, roll = res[0][0], int(x1p_truth["rolls"][0])
    check(got.align == roll, ("xona-x1p alignment", got.align, roll))
    log(f"[e2e_coherent] xona-x1p --coherent 100: alignment {got.align} "
        f"(truth {roll}), K6 launches {acquire_coh.LAUNCHES_BLK - n6}")
    os.remove(x1p)
    l5, l6 = acquire_coh.LAUNCHES_SPEC, acquire_coh.LAUNCHES_BLK
    log(f"[e2e_coherent] launches: acquire_coh_spec {l5}, acquire_coh {l6}")
    check(l5 > 0 and l6 > 0, (l5, l6))
    results["acquire_coh_spec"]["launches"] = l5
    results["acquire_coh"]["launches"] = l6
    check_covered("e2e_coherent", calls)
    log(f"[e2e_coherent] wall: synth {t_synth:.2f} s, beidou-b1i "
        f"--coherent 20 {t_b1i:.2f} s, gps-l1 --coherent 8 {t_l1:.2f} s, "
        f"xona-x1p --coherent 100 {t_x1p:.2f} s  [{card}]")

    # the non-coherent search of the same B1I capture, for comparison only
    t0 = time.perf_counter()
    with recording() as calls:
        out = run_cli(acq_cli.main, "beidou-b1i",
                      ["--time", "40", b1i, str(fs), "0", "--device",
                       str(dev)])
    torch.cuda.synchronize()
    check_covered("e2e_coherent", calls)
    hits = parse_hits(out)
    absent = max(h["metric"] for p, h in hits.items()
                 if p not in truth["prns"])
    for prn, dop, cp in zip(truth["prns"], truth["dops"], truth["phases"]):
        h = hits[prn]
        log(f"[e2e_coherent] non-coherent beidou-b1i prn {prn:2d}: doppler "
            f"{h['doppler']:7.1f} (truth {dop:7.1f}) code {h['code']:7.2f} "
            f"(truth {cp:7.2f}) metric {h['metric']:.2f}")
    log(f"[e2e_coherent] non-coherent beidou-b1i: best absent-PRN metric "
        f"{absent:.2f}, {time.perf_counter() - t0:.2f} s (not checked)")
    os.remove(b1i)
    os.remove(l1)


# ------------------------------------------------- phase e2e_coherent_track

def phase_e2e_coherent_track(dev, card, work, seconds=1.2):
    """tests/test_coherent.py::test_acquire_to_track_overlay_handoff at
    full size, on BeiDou B1I and on GPS L5Q (_coherent_track).  Returns
    K2's and K5's launches by signal, and B1I's track CLI call (its
    arguments, rows and capture, which e2e_mesh runs again through a
    mesh and then removes)."""
    from gnss_dsp_tpu_torch.tools.main_path import (
        B1I_FS, B1I_PRNS, L5Q_FS, L5Q_PRNS, synth_coherent_track)

    *b1i, b1i_track = _coherent_track(
        dev, card, work, "beidou-b1i", B1I_FS, seconds,
        lambda path: synth_coherent_track(
            path, "beidou-b1i", B1I_PRNS, B1I_FS, seconds, device=dev),
        (-2500.0, 2500.0, 25.0))
    *l5q, l5q_track = _coherent_track(
        dev, card, work, "gps-l5q", L5Q_FS, seconds,
        lambda path: synth_coherent_track(
            path, "gps-l5q", L5Q_PRNS, L5Q_FS, seconds, device=dev,
            dmax=400.0, seed=17),
        (-500.0, 500.0, 25.0))
    os.remove(l5q_track[2])
    return ({"beidou-b1i --coherent 20": tuple(b1i),
             "gps-l5q --coherent 20": tuple(l5q)}, b1i_track)


def _coherent_track(dev, card, work, name, fs, seconds, synth, grid):
    """The capture synth(path) writes (tools/main_path.synth_coherent_track:
    satellites at 32 dB-Hz, all from one overlay phase, dopplers within 4
    Hz of the 25 Hz grid), its coherent acquisition (the acquire CLI's
    --coherent 20 --time 40 path over every default PRN and `grid`: K5),
    then the track CLI with --coherent 20 --overlay-phase k
    --carrier-phase 0 on K2.  Checks: each planted PRN's doppler within
    one 25 Hz bin and code within 1 chip, its track_overlay_phase the
    truth; over the last 200 rows the mean carrier_f within 1 Hz of the
    truth and its spread under 1 Hz (the handoff test's bounds); C/N0 of
    the last 500 rows within 3 dB of the planted 32 dB-Hz.  Returns K2's
    and K5's launches and (the track CLI's arguments, its rows, the
    capture's path): the caller removes the capture."""
    import torch

    from gnss_dsp_tpu_torch.cli import cn0 as cn0_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.ops import acquire_coh, track_fused, track_step
    from gnss_dsp_tpu_torch.tools.main_path import (
        acquire_coherent, coherent_track_args, run_cli)

    tag = "e2e_coherent_track"
    path = os.path.join(work, f"e2e_{name}_track.iq")
    t0 = time.perf_counter()
    truth = synth(path)
    t_synth = time.perf_counter() - t0
    acquire_coh.LAUNCHES_SPEC = acquire_coh.LAUNCHES_BLK = 0
    t0 = time.perf_counter()
    with recording() as calls:
        res = acquire_coherent(path, name, fs, dev, doppler_search=grid)
    torch.cuda.synchronize()
    t_acq = time.perf_counter() - t0
    check_covered(tag, calls)
    k5 = acquire_coh.LAUNCHES_SPEC
    check(k5 > 0, (name, "K5 not on the path"))
    hits = {r.prn: r for r in res}
    L = truth["code_length"]
    for prn, dop, cp in zip(truth["prns"], truth["dops"], truth["phases"]):
        h = hits[prn]
        dc = abs(h.code_offset - cp) % L
        ovl = h.track_overlay_phase(L)
        check(abs(h.doppler - dop) <= 25.0 and min(dc, L - dc) <= 1.0
              and ovl == truth["overlay_phase"], (name, prn, h, dop, cp, ovl))
        log(f"[{tag}] {name} acquire prn {prn:2d}: doppler {h.doppler:7.1f} "
            f"(truth {dop:7.1f}) code {h.code_offset:8.2f} (truth "
            f"{cp:8.2f}) overlay phase {ovl} (truth "
            f"{truth['overlay_phase']})")

    track_fused.LAUNCHES = 0
    track_step.LAUNCHES_V2 = track_step.LAUNCHES_V1 = 0
    t0 = time.perf_counter()
    trk_args = coherent_track_args(name, hits, truth["prns"], path, fs, dev)
    with recording() as calls:
        out = run_cli(trk_cli.main, name, trk_args)
    torch.cuda.synchronize()
    t_trk = time.perf_counter() - t0
    check_covered(tag, calls)
    lt = track_fused.LAUNCHES
    check(lt > 0 and track_step.LAUNCHES_V2 == track_step.LAUNCHES_V1 == 0,
          (name, "K2 not the route", lt, track_step.LAUNCHES_V2))
    rows = _rows_by_prn(out)
    for prn, dop in zip(truth["prns"], truth["dops"]):
        r = rows[prn]
        cf = np.array([float(v.split()[3]) for v in r[-200:]])
        est = run_cli(cn0_cli.main, ["--time", "500"],
                      stdin_text="\n".join(r[-500:]) + "\n").split()
        c = float(est[0])
        check(len(r) >= 1000 and abs(np.mean(cf) - dop) < 1.0
              and np.std(cf) < 1.0 and abs(c - truth["cn0"]) <= 3.0,
              (name, prn, len(r), np.mean(cf) - dop, np.std(cf), c))
        log(f"[{tag}] {name} track prn {prn:2d}: {len(r)} rows, last 200 "
            f"mean carrier_f - truth {np.mean(cf) - dop:+.3f} Hz, spread "
            f"{np.std(cf):.3f} Hz, C/N0 {c:.2f} dB-Hz (truth "
            f"{truth['cn0']:g})")
    log(f"[{tag}] {name} wall: synth {t_synth:.2f} s, coherent acquire "
        f"{t_acq:.2f} s (K5 launches {k5}), track --coherent 20 "
        f"{len(truth['prns'])} ch x {seconds} s at {fs:g} Hz {t_trk:.2f} s, "
        f"K2 launches {lt}  [{card}]")
    return lt, k5, (trk_args, out, path)


# ---------------------------------------------------------- phase e2e_wide

def phase_e2e_wide(dev, card, results, work):
    """The acquire CLI on one capture per wide route; returns K1's
    launches over the phase."""
    import torch

    from gnss_dsp_tpu_torch.acquire.plan import acq_plan
    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import acquire, acquire2
    from gnss_dsp_tpu_torch.tools.main_path import (
        parse_hits, run_cli, synth_at_acq_fs)

    k1 = 0
    for i, name in enumerate(E2E_WIDE):
        sig = get_signal(name)
        route = acq_plan(sig)[0]
        path = os.path.join(work, f"e2e_{name}.iq")
        t0 = time.perf_counter()
        truth = synth_at_acq_fs(path, name, 0.085, seed=20 + i)
        t_synth = time.perf_counter() - t0
        acquire.LAUNCHES = 0
        acquire2.LAUNCHES = 0
        t0 = time.perf_counter()
        with recording() as calls:
            out = run_cli(acq_cli.main, name,
                          ["--time", "80", path, str(truth["fs"]), "0",
                           "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        l7, l1 = acquire.LAUNCHES, acquire2.LAUNCHES
        log(f"[e2e_wide] {name}: route {route}, launches acquire {l7}, "
            f"acquire2 {l1}")
        if route == "v1":
            check(l7 > 0 and l1 == 0, (name, "K7 not on the path", l7, l1))
            results["acquire"]["launches"] += l7
        else:
            check(l1 > 0 and l7 == 0, (name, "K1 not on the path", l7, l1))
            k1 += l1
        check_covered("e2e_wide", calls)
        hits = parse_hits(out)
        check(sorted(hits) == sorted(sig.prns()), (name, sorted(hits)))
        check_hits(name, hits, truth, sig.doppler_default[2],
                   phase="e2e_wide")
        log(f"[e2e_wide] {name}: {len(sig.prns())} PRNs, "
            f"{len(np.arange(*sig.doppler_default))} dopplers, capture "
            f"{truth['fs']:g} Hz; synth {t_synth:.2f} s, acquire CLI "
            f"{wall:.2f} s  [{card}]")
        os.remove(path)
    return k1


# -------------------------------------------------- phase e2e_coherent_wide

def phase_e2e_coherent_wide(dev, card, work):
    """The acquire CLI with --coherent on one capture per window class of
    tools/main_path.COHERENT_WIDE (main_path.synth_at_acq_fs: 4 satellites
    at the signal's acq_fs within +-450 Hz, carrying their overlay from a
    random chip); returns K5's launches over the phase."""
    import torch

    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import acquire_coh
    from gnss_dsp_tpu_torch.tools.main_path import (
        COHERENT_WIDE, parse_hits, returns_of, run_cli, synth_at_acq_fs)

    k5 = 0
    for i, (name, m, ms, step, cn0) in enumerate(COHERENT_WIDE):
        sig = get_signal(name)
        overlay = sig.secondary is not None
        path = os.path.join(work, f"e2e_coherent_{name}.iq")
        t0 = time.perf_counter()
        truth = synth_at_acq_fs(path, name, (ms + 6) / 1000.0, cn0=cn0,
                                seed=30 + i, dop_max=450.0, overlay=overlay)
        t_synth = time.perf_counter() - t0
        acquire_coh.LAUNCHES_SPEC = acquire_coh.LAUNCHES_BLK = 0
        t0 = time.perf_counter()
        with recording() as calls, \
                returns_of(acq_cli, "acquire_signal_coherent") as res:
            out = run_cli(acq_cli.main, name, [
                "--coherent", str(m), "--time", str(ms), "--doppler-search",
                f"-500,500,{step:g}", path, str(truth["fs"]), "0",
                "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        os.remove(path)
        l5, l6 = acquire_coh.LAUNCHES_SPEC, acquire_coh.LAUNCHES_BLK
        check(l5 > 0 and l6 == 0, (name, "K5 not on the path", l5, l6))
        k5 += l5
        check_covered("e2e_coherent_wide", calls)
        hits = parse_hits(out)
        check(sorted(hits) == sorted(sig.prns()), (name, sorted(hits)))
        check_hits(name, hits, truth, step, phase="e2e_coherent_wide")
        # linear windows: block m holds code period m + 1 whole, which
        # carries overlay chip (roll + m + 1) mod N
        N = len(sig.secondary(truth["prns"][0])) if overlay else 1
        got = {r.prn: r for r in res[0]}
        for prn, roll in zip(truth["prns"], truth["rolls"]):
            want = (int(roll) + 1) % N
            check(got[prn].align == want, (name, prn, got[prn], want))
        log(f"[e2e_coherent_wide] {name} --coherent {m} --time {ms}: "
            f"{len(sig.prns())} PRNs, "
            f"{len(np.arange(-500.0, 500.0, step))} dopplers at {step:g} Hz, "
            f"alignments the truth's {[got[p].align for p in truth['prns']]}"
            f"; K5 launches {l5}; synth {t_synth:.2f} s, acquire CLI "
            f"{wall:.2f} s  [{card}]")
    return k5


# ---------------------------------------------------------- phase e2e_mesh

def _workers(args, timeout=600):
    """Run the multihost_worker command lines `args` together from the
    repo root; every process is stopped before this returns.  Returns
    their outputs."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gnss_dsp_tpu_torch.tools.multihost_worker",
         *a], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for a in args]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        check(p.returncode == 0, ("multihost_worker failed", out[-3000:]))
    return outs


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def phase_e2e_mesh(dev, card, results, work, e2e, b1i_track):
    """The sharded paths on the card: (a) acquire --mesh 1 on the e2e
    capture against the single-card CLI; (b) acquire_signal_sharded on a
    2 x 2 mesh over the one card for GPS L1 (K1's surface), GPS L5I (K7 at
    61380) and GPS L2CM (K1's surface at 163840); (c) track --mesh over two
    sat shards of the card, on the e2e channels and on the coherent B1I
    ones, against the single-card rows; (d) the GPS L1 search as two gloo
    ranks sharing the card on a 1 x 2 mesh, against (a).  Returns the
    capture paths it is done with."""
    import torch

    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import acquire, acquire2, track_fused
    from gnss_dsp_tpu_torch.ops.frontend import prepare_baseband
    from gnss_dsp_tpu_torch.parallel.acquire import (
        acquire_signal_sharded, mesh_dop_chunk)
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh
    from gnss_dsp_tpu_torch.tools.main_path import (
        returns_of, run_cli, synth_at_acq_fs)

    tag = "e2e_mesh"
    path, fs, specs, track_out, truth = e2e
    truth = dict(truth, code_length=1023)

    # (a) acquire --mesh 1: the CLI's sharded path on a 1 x 1 mesh
    args = [path, str(fs), "0", "--device", str(dev)]
    with returns_of(acq_cli, "acquire_signal") as one:
        single = run_cli(acq_cli.main, "gps-l1", args)
    acquire2.LAUNCHES_SURFACE = 0
    t0 = time.perf_counter()
    with recording() as calls, \
            returns_of(acq_cli, "acquire_signal_sharded") as res:
        meshed = run_cli(acq_cli.main, "gps-l1", ["--mesh", "1"] + args)
    torch.cuda.synchronize()
    t_a = time.perf_counter() - t0
    check_covered(tag, calls)
    surface = acquire2.LAUNCHES_SURFACE
    check(surface > 0, "(a): K1's surface not on the path")
    a_res = res[0]
    digits = 0
    for r1, rm in zip(one[0], a_res):
        check((r1.prn, r1.doppler, r1.code_offset)
              == (rm.prn, rm.doppler, rm.code_offset), ("(a)", r1, rm))
        check(abs(rm.metric - r1.metric) <= 1e-5 * abs(r1.metric),
              ("(a) metric", r1, rm))
    for l1, lm in zip(single.splitlines(), meshed.splitlines()):
        digits += l1 != lm
    check(len(single.splitlines()) == len(meshed.splitlines()) == 32)
    log(f"[{tag}] (a) acquire --mesh 1: 32 rows, {32 - digits} text for "
        f"text equal to the single-card CLI's, {digits} differing in the "
        f"metric's last digit (winners equal, metric within rtol 1e-5); "
        f"K1 surface launches {surface}, {t_a:.2f} s  [{card}]")

    # (b) a 2 x 2 mesh over the one card
    mesh = make_mesh(devices=[dev] * 4)
    check(mesh.shape == {"sat": 2, "time": 2}, mesh)
    k7 = 0
    xb_l1 = None
    for i, name in enumerate(("gps-l1", "gps-l5i", "gps-l2cm")):
        sig = get_signal(name)
        if name == "gps-l1":
            cpath, cfs, ctruth = path, fs, truth
        else:
            cpath = os.path.join(work, f"e2e_mesh_{name}.iq")
            ctruth = synth_at_acq_fs(cpath, name, 0.085, seed=50 + i)
            cfs = ctruth["fs"]
        x = acq_cli.read_samples(cpath, int(85 * cfs / 1000), dev)
        xb = prepare_baseband(x, cfs, 0.0, sig.acq_fs, sig.acq_lowpass_hz,
                              82)
        if name == "gps-l1":
            xb_l1 = xb
        else:
            os.remove(cpath)
        acquire.LAUNCHES = 0
        acquire2.LAUNCHES_SURFACE = 0
        t0 = time.perf_counter()
        with recording() as calls:
            got = acquire_signal_sharded(sig, xb, sig.prns(), mesh, ms=80)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_covered(tag, calls)
        l7, l1s = acquire.LAUNCHES, acquire2.LAUNCHES_SURFACE
        if name == "gps-l5i":
            check(l7 > 0 and l1s == 0, (name, "K7 not on the path", l7, l1s))
            k7 += l7
        else:
            check(l1s > 0 and l7 == 0, (name, "K1 not on the path", l7, l1s))
            surface += l1s
        hits = {r.prn: dict(doppler=r.doppler, metric=r.metric,
                            code=r.code_offset) for r in got}
        check(sorted(hits) == sorted(sig.prns()), (name, sorted(hits)))
        check_hits(f"{name} 2 x 2", hits, ctruth, sig.doppler_default[2],
                   phase=tag)
        log(f"[{tag}] (b) {name} on a 2 x 2 mesh over the card: launches "
            f"K7 {l7}, K1 surface {l1s}; search {wall:.2f} s  [{card}]")

    # (c) track --mesh over two sat shards of the card (the track CLI's
    # meshes have one time shard, as the reference's: a 2 x 2 grid tracks
    # on its two sat rows)
    shards = trk_cli.cli_devices
    trk_cli.cli_devices = lambda device, n: [dev] * 2
    try:
        track_fused.LAUNCHES = 0
        t0 = time.perf_counter()
        with recording() as calls:
            out = run_cli(trk_cli.main, "gps-l1",
                          ["--mesh", "2", "--blocks", "2150", "--device",
                           str(dev), path, str(fs), "0", specs])
        torch.cuda.synchronize()
        t_c = time.perf_counter() - t0
        check_covered(tag, calls)
        check(out == track_out, "(c): track --mesh rows differ")
        lt = track_fused.LAUNCHES
        b_args, b_out, b_path = b1i_track
        with recording() as calls:
            out = run_cli(trk_cli.main, "beidou-b1i", ["--mesh", "2"] + b_args)
        torch.cuda.synchronize()
        check_covered(tag, calls)
        check(out == b_out, "(c): track --mesh --coherent 20 rows differ")
        lc = track_fused.LAUNCHES - lt
    finally:
        trk_cli.cli_devices = shards
    check(lt > 0 and lc > 0, ("(c): K2 not on the path", lt, lc))
    results["track_fused"]["launches"] += lt + lc
    log(f"[{tag}] (c) track --mesh 2 (shards of 4 channels), 8 ch x 2150 "
        f"blocks: rows byte-equal to the single-card CLI's, K2 launches "
        f"{lt}, {t_c:.2f} s; track --mesh 2 --coherent 20, 6 B1I ch: rows "
        f"byte-equal, K2 launches {lc}  [{card}]")

    # (d) two gloo ranks sharing the card, the sum over time shards
    # crossing the ranks
    sig = get_signal("gps-l1")
    dops = np.arange(*sig.doppler_default)
    in_npz = os.path.join(work, "e2e_mesh_in.npz")
    out_npz = os.path.join(work, "e2e_mesh_out.npz")
    np.savez(in_npz, sig="gps-l1", acq_fs=sig.acq_fs,
             x=xb_l1.cpu().numpy(), prns=list(sig.prns()),
             dop_search=sig.doppler_default, ms=80,
             dop_chunk=mesh_dop_chunk(len(sig.prns()), 4096, len(dops)))
    port = _free_port()
    t0 = time.perf_counter()
    outs = _workers([[str(pid), "2", str(port), in_npz, out_npz, "--device",
                      "cuda", "--shards", "1", "--time-shards", "2"]
                     for pid in (0, 1)])
    t_d = time.perf_counter() - t0
    got = np.load(out_npz)
    for i, r in enumerate(a_res):
        check((int(got["prn"][i]), float(got["doppler"][i]),
               float(got["code_offset"][i]))
              == (r.prn, r.doppler, r.code_offset), ("(d)", i, r))
        check(abs(float(got["metric"][i]) - r.metric) <= 1e-5 * r.metric,
              ("(d) metric", i, r, float(got["metric"][i])))
    os.remove(in_npz)
    os.remove(out_npz)
    log(f"[{tag}] (d) two gloo ranks on one card, 1 x 2 mesh: 32 winners "
        f"equal to (a)'s, metric within rtol 1e-5; {t_d:.2f} s with the "
        f"processes' start ({outs[0].strip().splitlines()[-1]})  [{card}]")
    results["acquire2_surface"]["launches"] = surface
    results["acquire_61380"]["launches"] = k7
    return b_path


# ---------------------------------------------------------- phase e2e_fdma

def _fdma_results(one, other, what):
    """AcqResults of two FDMA searches: channel, doppler and code offset
    equal, metric within rtol 1e-5."""
    check(len(one) == len(other), (what, len(one), len(other)))
    for a, b in zip(one, other):
        check((a.prn, a.doppler, a.code_offset)
              == (b.prn, b.doppler, b.code_offset), (what, a, b))
        check(abs(a.metric - b.metric) <= 1e-5 * abs(a.metric),
              (what, "metric", a, b))


def phase_e2e_fdma(dev, card, results, work):
    """GLONASS FDMA through the acquire CLI: (a) a GLONASS L1 capture at
    16.384 MHz (main_path.synth_fdma: 4 channels at 45 dB-Hz within
    +-450 Hz among the default -7:7), the default grid, --time 80 (K1,
    one code row against 15 x 70 increments): every live channel within
    one bin and one chip, above every dead channel; the search alone
    timed (device time and cells per second, the JAX package's
    glonass_l1_fdma_acq_cells_per_s_sustained cells 15 x 70 x 16384 x 80);
    (b) --mesh on a 2 x 2 mesh of the card (K1's surface): the single-card
    results (channel, doppler and code exact, metric rtol 1e-5); (c)
    --coherent 8 over +-500 Hz at 62.5 Hz (K5, one launch a channel): the
    live channels found within one bin and one chip; (d) GLONASS L2 once
    through the plain CLI (4 channels within +-4 kHz)."""
    import torch

    from gnss_dsp_tpu_torch.acquire.engine import (
        _block_count, acquire_signal_fdma, fdma_grid)
    from gnss_dsp_tpu_torch.acquire.plan import acq_plan
    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import acquire2, acquire_coh
    from gnss_dsp_tpu_torch.ops.frontend import prepare_baseband
    from gnss_dsp_tpu_torch.tools.main_path import (
        parse_hits, returns_of, run_cli, synth_fdma)

    tag = "e2e_fdma"
    name = E2E_FDMA[0]
    sig = get_signal(name)
    path = os.path.join(work, f"{tag}_{name}.iq")
    truth = synth_fdma(path, name, 0.085, seed=61, device=dev)
    fs = truth["fs"]
    args = ["--time", "80", path, "%d" % fs, "0", "--device", str(dev)]
    chans = sig.prns()

    # (a) the plain CLI
    acquire2.LAUNCHES = 0
    t0 = time.perf_counter()
    with recording() as calls, \
            returns_of(acq_cli, "acquire_signal_fdma") as one:
        out = run_cli(acq_cli.main, name, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_covered(tag, calls)
    k1 = acquire2.LAUNCHES
    check(k1 > 0, "(a): K1 not on the path")
    hits = parse_hits(out)
    check(sorted(hits) == chans, (tag, sorted(hits)))
    check_hits(name, hits, truth, sig.doppler_default[2], phase=tag)
    x = acq_cli.read_samples(path, int(85 * fs / 1000), dev)
    xb = prepare_baseband(x, fs, 0.0, sig.acq_fs, sig.acq_lowpass_hz, 82)

    def search():
        return acquire_signal_fdma(sig, xb, chans, ms=80)

    search()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    busy = device_ms(search, 2)
    D = len(fdma_grid(sig, sig.doppler_default, chans)[0][0])
    W, B = acq_plan(sig)[1], _block_count(sig, 80)
    cells = len(chans) * D * W * B
    log(f"[{tag}] (a) {name} CLI: {len(chans)} channels x {D} dopplers x "
        f"{B} blocks x {W}, K1 launches {k1}, CLI {wall:.2f} s; the search "
        f"alone "
        f"{warm * 1e3:.2f} ms host wall, {busy:.3f} ms device time: "
        f"{cells / (busy / 1e3) / 1e9:.4g} Gcells/s by device time, "
        f"{cells / warm / 1e9:.4g} by host wall  [{card}]")

    # (b) --mesh 4: a 2 x 2 mesh over the card
    saved = acq_cli.cli_devices
    acq_cli.cli_devices = lambda device, n: [dev] * 4
    try:
        acquire2.LAUNCHES_SURFACE = 0
        t0 = time.perf_counter()
        with recording() as calls, \
                returns_of(acq_cli, "acquire_signal_fdma_sharded") as res:
            run_cli(acq_cli.main, name, ["--mesh", "4"] + args)
        torch.cuda.synchronize()
        t_b = time.perf_counter() - t0
    finally:
        acq_cli.cli_devices = saved
    check_covered(tag, calls)
    k1s = acquire2.LAUNCHES_SURFACE
    check(k1s > 0, "(b): K1's surface not on the path")
    _fdma_results(one[0], res[0], "(b) --mesh")
    log(f"[{tag}] (b) {name} --mesh on a 2 x 2 mesh of the card: 15 "
        f"channels equal to the single-card CLI's (metric rtol 1e-5), K1 "
        f"surface launches {k1s}, {t_b:.2f} s  [{card}]")

    # (c) --coherent 8 over +-500 Hz
    _, m, ms, step = FDMA_COHERENT
    acquire_coh.LAUNCHES_SPEC = acquire_coh.LAUNCHES_BLK = 0
    t0 = time.perf_counter()
    with recording() as calls:
        out = run_cli(acq_cli.main, name, [
            "--coherent", str(m), "--time", str(ms), "--doppler-search",
            f"-500,500,{step:g}", path, "%d" % fs, "0", "--device",
            str(dev)])
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    check_covered(tag, calls)
    k5 = acquire_coh.LAUNCHES_SPEC
    check(k5 == len(chans) and acquire_coh.LAUNCHES_BLK == 0,
          ("(c): K5 not the route", k5, acquire_coh.LAUNCHES_BLK))
    hits = parse_hits(out)
    check(sorted(hits) == chans, (tag, "(c)", sorted(hits)))
    check_hits(f"{name} --coherent {m}", hits, truth, step, phase=tag)
    os.remove(path)
    log(f"[{tag}] (c) {name} --coherent {m} --time {ms}, 16 dopplers at "
        f"{step:g} Hz: K5 launches {k5}, {t_c:.2f} s  [{card}]")

    # (d) GLONASS L2 through the plain CLI
    name = E2E_FDMA[1]
    sig = get_signal(name)
    path = os.path.join(work, f"{tag}_{name}.iq")
    truth = synth_fdma(path, name, 0.085, seed=62, dop_max=4000.0,
                       device=dev)
    acquire2.LAUNCHES = 0
    t0 = time.perf_counter()
    with recording() as calls:
        out = run_cli(acq_cli.main, name, ["--time", "80", path,
                                           "%d" % truth["fs"], "0",
                                           "--device", str(dev)])
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    check_covered(tag, calls)
    os.remove(path)
    k1d = acquire2.LAUNCHES
    check(k1d > 0, "(d): K1 not on the path")
    hits = parse_hits(out)
    check(sorted(hits) == sig.prns(), (tag, "(d)", sorted(hits)))
    check_hits(name, hits, truth, sig.doppler_default[2], phase=tag)
    k1 += k1d
    log(f"[{tag}] (d) {name} CLI: K1 launches {k1d}, "
        f"{t_d:.2f} s  [{card}]")
    log(f"[{tag}] launches: K1 {k1}, K1 surface {k1s}, K5 {k5}")
    results["acquire2"]["launches"] += k1
    results["acquire2_surface"]["launches"] += k1s
    results["acquire_coh_spec"]["launches"] += k5


# -------------------------------------------------------- phase e2e_serial

def serial_q_host(sig, xw, geom, code, k):
    """q of hypothesis k on the host: the chip indices in the searches'
    float32 arithmetic (s_frac + i * incr, each rounded), the +-1 chips
    times the wiped blocks xw (complex [B, n]) summed in float64."""
    i = np.arange(geom.n, dtype=np.float32) * np.float32(geom.incr)
    cp = geom.s_frac[k][:, None] + i[None, :]
    idx = (geom.s_int[k][:, None].astype(np.int64)
           + np.floor(cp).astype(np.int64)) % geom.L
    y = (code[idx].astype(np.float64) * xw.astype(np.complex128)).sum(-1)
    return float(np.abs(y).sum())


def phase_e2e_serial(dev, card, work):
    """The assisted serial searches through the acquire CLI, on one
    satellite at 45 dB-Hz planted at hypothesis k (main_path.synth_serial)
    for each of E2E_SERIAL (GPS L2CL at 4.096 MHz, --time 40, 75
    hypotheses; GLONASS L1 P at 16.384 MHz, --time 80, 1000 hypotheses on
    FDMA channel 3): k found exactly and its code phase printed; q at k
    within rtol 1e-6 of a float64 host evaluation on the same wiped
    samples; then serial_search_sharded on a 2 x 2 mesh of the card: the
    same k, metric rtol 1e-5."""
    import torch

    from gnss_dsp_tpu_torch.acquire import serial
    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops.frontend import mix_long
    from gnss_dsp_tpu_torch.parallel.acquire import serial_search_sharded
    from gnss_dsp_tpu_torch.parallel.mesh import make_mesh
    from gnss_dsp_tpu_torch.tools.main_path import (
        returns_of, run_cli, synth_serial)

    tag = "e2e_serial"
    for i, (name, fs, ms, prn, k, pp, dop) in enumerate(E2E_SERIAL):
        sig = get_signal(name)
        chan = prn if sig.fdma_hz else 0
        path = os.path.join(work, f"{tag}_{name}.iq")
        synth_serial(path, name, fs, (ms + 3) / 1000.0, prn, k, pp, dop,
                     seed=70 + i, device=dev)
        t0 = time.perf_counter()
        with returns_of(acq_cli, "serial_search") as res:
            out = run_cli(acq_cli.main, name, [
                "--time", str(ms), path, "%d" % fs, "0", str(prn), str(dop),
                str(pp), "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = res[0]
        want = "%f" % (sig.acq_serial_stride * k + sig.acq_serial_scale * pp)
        check(r.k == k and out.split()[0] == want, (name, out, want, r))
        x = mix_long(acq_cli.read_samples(path, int((ms + 2) * fs / 1000),
                                          dev), 0.0)
        os.remove(path)
        geom = serial.hypothesis_geometry(sig, fs, ms, pp)
        xw = serial.wipe_blocks(sig, x, dop, fs, chan, geom).cpu().numpy()
        q = serial_q_host(sig, xw, geom, sig.code_table((prn,))[0], k)
        check(abs(r.metric - q) <= 1e-6 * q, (name, "q at k", r.metric, q))
        t0 = time.perf_counter()
        sh = serial_search_sharded(sig, x, prn, dop, pp, fs,
                                   make_mesh(devices=[dev] * 4), ms=ms,
                                   chan=chan)
        torch.cuda.synchronize()
        t_sh = time.perf_counter() - t0
        check(sh.k == k and abs(sh.metric - r.metric) <= 1e-5 * r.metric,
              (name, "sharded", sh, r))
        log(f"[{tag}] {name} ({sig.acq_serial} hypotheses, {geom.blocks} "
            f"blocks of {geom.n} at {fs:g} Hz, {'chan' if chan else 'prn'} "
            f"{prn}): k {r.k}, printed code phase {out.split()[0]} (the "
            f"planted one), q at k {r.metric:.6g} against the float64 host "
            f"evaluation {q:.6g} (rtol 1e-6); CLI {wall:.2f} s; the sharded "
            f"search on a 2 x 2 mesh of the card k {sh.k}, metric within "
            f"rtol 1e-5, {t_sh:.2f} s  [{card}]")


# ------------------------------------------------- phase k2_slice (K2 shapes)

# the slice's mixes through `track multi` (e2e_multi): (tag, [(signal, prn
# or FDMA channel, doppler, code phase, carrier offset)], capture rate).
# L2CL's code phase lies near its end, so its first boundary (the 1.5 s
# code's) falls in the capture
E2E_MULTI = (
    ("tmboc", [("gps-l1cp", 3, 700.0, 5100.4, 0.0),
               ("gps-l1cp", 11, -1900.0, 812.6, 0.0),
               ("gps-l1", 7, 900.0, 317.25, 0.0),
               ("gps-l1", 21, -2400.0, 77.5, 0.0)], 8.192e6),
    ("long_code", [("gps-l2cl", 7, 900.0, 767200.5, 0.0),
                   ("gps-l2cl", 12, -1300.0, 767100.25, 0.0),
                   ("gps-l2cm", 29, 1120.0, 4208.8, 0.0)], 4.096e6),
)
# the coherent receiver (e2e_receiver): B1I on band 1 and B2I on band 2
# at 16.368 MHz, each with its NH20 from overlay phase COH_ROLL
COH_RX_FS = 16.368e6
COH_RX = {1: [("beidou-b1i", 11, 1250.0, 1500.6, 0.0)],
          2: [("beidou-b2i", 14, -600.0, 1682.9, 0.0)]}
COH_ROLL = 7
RX_SECONDS = 1.5          # the 2017 sky's capture (e2e_receiver)
RX_CHUNK_MS = 500.0
RX_HELD_BLOCKS = 600      # two chunks: the whole first, 98 blocks after the rebase


def _k2_mix(dev, card, tag, mix, fs, coh, seed, seconds, nb=None):
    """K2 against its plain version at a mixed-signal launch shape
    (tools/track_all.mixed_inputs: the mix at fs, 45 dB-Hz, each channel
    from its first code boundary, the setup of track multi): with nb, one
    launch of nb blocks; else a launch whose chunk ends at 45% of the
    capture (every channel stalls), then the refill.  Rows, int rows and
    state bit-equal.  Then the time of one launch, the plain version's
    and the bound.  Returns the numbers."""
    import torch

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops import track_fused
    from gnss_dsp_tpu_torch.tools.track_all import mixed_inputs
    from gnss_dsp_tpu_torch.track.engine import track_scan, track_scan_plain

    d = mixed_inputs(mix, fs, seconds, seed, dev, coherent_blocks=coh)
    p = d["params"]
    C = len(mix)
    check(p.fused_scan, (tag, "not K2", p))
    extra = (d["ratios"], d["cdf"], d["sigp"], d["overlay"])
    sigs = [get_signal(m[0]) for m in mix]
    full = torch.full((C,), d["n"], dtype=torch.int32, device=dev)
    blocks = nb or int(seconds * 1000) + 2
    runs = (((full, nb),) if nb else
            ((torch.full_like(full, int(0.45 * d["n"])), blocks),
             (full, blocks)))
    st = d["st"]
    for launch, (cl, nbl) in enumerate(runs):
        k = track_scan(d["x"], cl, d["tab"], st, p, nbl, *extra)
        pl = track_scan_plain(d["x"], cl, d["tab"], st, p, nbl, *extra)
        torch.cuda.synchronize()
        torch.testing.assert_close(k[2], pl[2], rtol=0, atol=0)
        torch.testing.assert_close(k[1], pl[1], rtol=0, atol=0,
                                   equal_nan=True)
        for field, a, b in zip(k[0]._fields, k[0], pl[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0,
                                       msg=f"{tag} state {field}")
        if not nb:
            check(bool(k[0].stalled.all()), (tag, launch, "not stalled"))
        st = k[0]._replace(stalled=torch.zeros_like(k[0].stalled))
    rows = int((k[2][:, :, 0] > 0).sum())
    CHECKED["track_fused"].append(fused_key("track_fused", d["x"], d["n"],
                                            d["tab"], d["st"], p))

    def run_kernel():
        return track_scan(d["x"], full, d["tab"], d["st"], p, blocks, *extra)

    ms = cuda_ms(run_kernel, 3)
    plain_ms = cuda_ms(lambda: track_scan_plain(
        d["x"], full, d["tab"], d["st"], p, blocks, *extra), 1)
    ns = run_kernel()[2][..., 0].to(torch.float64).sum(0).cpu().numpy()
    chips = sum(min(s.code_length, int(v * s.chip_rate / fs) + 3)
                for s, v in zip(sigs, ns))
    bms, by = k2_bound(d["x"].numel(), chips, blocks * C, float(ns.sum()),
                       p.subcarrier)
    plan = track_fused.cluster_plan(C, p.nmax)
    log(f"[k2_slice] {tag}: {C} channels ({', '.join(m[0] for m in mix)}) "
        f"at {fs:g} Hz, kind {p.subcarrier}, nmax {p.nmax}, code table "
        f"{tuple(d['tab'].shape)}, M {p.coh_blocks}; plan: {plan['cluster']}"
        f" CTAs a channel, {plan['tiles']} tiles, {plan['batches']} "
        f"batch(es); {len(runs)} launch(es) bit-equal to the plain version "
        f"({rows} rows in the last); one launch of {blocks} blocks "
        f"{ms:.3f} ms ({ns.sum() / ms / 1e3:.4g} Msamples/s), plain "
        f"{plain_ms:.3f} ms, bound {bms:.4f} ms by {by}  [{card}]")
    return dict(name=tag, channels=C, fs=fs, coherent=p.coh_blocks,
                blocks=blocks, nmax=p.nmax, kind=p.subcarrier,
                code=list(d["tab"].shape), plan=plan, max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def phase_k2_slice(dev, card, results):
    """K2 against its plain version at every launch shape of the new
    phases: the 2017 sky's 11 channels at 69.984 MHz in one launch (nmax
    104980: 8 CTAs a channel, the window in two batches; 40 blocks), its
    three bands as `track multi` launches them, the coherent receiver
    (B1I and B2I at 16.368 MHz, M = 20), e2e_multi's TMBOC mix (and its
    two-channel shard under --mesh 2) and its long-code mix (L2CL's
    767,250 chips in the table)."""
    from gnss_dsp_tpu_torch.ops import track_fused
    from gnss_dsp_tpu_torch.tools.receiver_sky import BANDS, FS

    sky = [s for seeds in BANDS.values() for s in seeds]
    out = [_k2_mix(dev, card, "receiver", sky, FS, 1, 81, 0.045, nb=40)]
    check(out[0]["nmax"] == 104980 and out[0]["plan"]["cluster"] == 8
          and out[0]["plan"]["batches"] == 2,
          ("receiver plan", out[0]["plan"]))
    info = track_fused.launch_info(104980, 8, out[0]["kind"])
    log(f"[k2_slice] receiver: the card's plan {info}")
    for b, seeds in BANDS.items():
        out.append(_k2_mix(dev, card, f"band {b}", seeds, FS, 1, 81 + b,
                           0.03))
    coh = [s for seeds in COH_RX.values() for s in seeds]
    out.append(_k2_mix(dev, card, "coherent receiver", coh, COH_RX_FS, -1,
                       85, 0.3))
    for i, (tag, mix, fs) in enumerate(E2E_MULTI):
        out.append(_k2_mix(dev, card, f"multi {tag}", mix, fs, 1, 86 + i,
                           0.06))
    tag, mix, fs = E2E_MULTI[0]
    out.append(_k2_mix(dev, card, f"multi {tag}, a --mesh 2 shard",
                       mix[:2], fs, 1, 88, 0.06))
    results["track_fused"]["shapes"] += out


# ------------------------------------------------------ phase e2e_receiver

def _rows_text(rows):
    """{"SIG:prn": [row dicts]} -> the same rows as `track multi` prints
    them (after the prefix)."""
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.track.driver import format_row_9, format_row_14

    out = {}
    for key, r in rows.items():
        fmt = (format_row_14 if get_signal(key.split(":")[0]).row_format
               == 14 else format_row_9)
        out[key] = [fmt(v) for v in r]
    return out


def _receiver_profile(paths, dev, work):
    """The one-program receiver once more under torch.profiler: (wall,
    device busy seconds, K2's device seconds and kernel count, the
    largest device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gnss_dsp_tpu_torch.tools.main_path import device_busy_us
    from gnss_dsp_tpu_torch.tools.receiver_sky import run_receiver

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_receiver(paths, dev, RX_CHUNK_MS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = device_busy_us((e.time_range.start, e.time_range.end)
                          for e in ev) / 1e6
    k2 = [e for e in ev if "track_fused_kernel" in e.name]
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:6]
    prof.export_chrome_trace(os.path.join(work, "trace_receiver.json"))
    return wall, busy, sum(e.time_range.elapsed_us() for e in k2) / 1e6, \
        len(k2), [(e.key[:50], e.self_device_time_total / 1e3, e.count)
                  for e in top]


def phase_e2e_receiver(dev, card, results, work):
    """The 2017 three-band sky (tools/receiver_sky: the 11 golden seeds at
    69.984 MHz, each band's stream synthesised on the card in 125 ms
    chunks, 45 dB-Hz, RX_SECONDS): the three per-band `track multi` CLI
    runs, then track_receiver over all 11 channels in one program at
    chunk_ms 500 (so the per-band rebase runs between chunks), one K2
    launch a chunk (the counts set to 0 just before, read just after).
    Every channel of both: >= 0.9 rows a millisecond, the median carrier_f
    of the last 200 rows within 8 Hz of the seed, prompt above early and
    late; the receiver's rows against the per-band runs' at rtol 2e-3 /
    atol 2e-2 (the reference's tolerance) and text-equal.  The receiver's
    own scans of its first two chunks (band segments, per-band chunk
    ends, offset pointers, the rebase between them) bit-equal to the
    plain version on the same arguments.  Then the receiver under
    torch.profiler (K2's device time, busy and idle shares), under
    GNSS_DSP_UPLOAD_INT4 (every channel locked, half the bytes uploaded a
    chunk), and the coherent receiver (B1I and B2I at 16.368 MHz, NH20
    from one overlay phase, coherent_blocks -1): mean carrier_f of the
    last 200 rows within 1 Hz.  Returns K2's launches."""
    import torch

    from gnss_dsp_tpu_torch.ops import track_fused, track_step
    from gnss_dsp_tpu_torch.tools.main_path import environ
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.receiver_sky import (
        BANDS, FS, run_per_band, run_receiver, scans_held_to_plain,
        synth_bands, validate)

    tag = "e2e_receiver"
    paths = {b: os.path.join(work, f"sky_band{b}.iq") for b in BANDS}
    t0 = time.perf_counter()
    synth_bands(paths, RX_SECONDS, device=dev)
    torch.cuda.synchronize()
    log(f"[{tag}] synthesised {RX_SECONDS} s x 3 bands at 69.984 MHz on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    with recording() as calls:
        per, walls = run_per_band(paths, dev, RX_CHUNK_MS)
    torch.cuda.synchronize()
    check_covered(tag, calls)
    lines, fails = validate(per, RX_SECONDS)
    for ln in lines:
        log(f"[{tag}] per band {ln}")
    check(not fails, (tag, "per band", fails))

    track_fused.LAUNCHES = track_step.LAUNCHES_V2 = 0
    track_step.LAUNCHES_V1 = 0
    stats = {}
    with recording() as calls:
        one, wall = run_receiver(paths, dev, RX_CHUNK_MS, stats=stats)
    torch.cuda.synchronize()
    k2 = track_fused.LAUNCHES
    check_covered(tag, calls)
    chunks = stats["chunks"]
    check(k2 == chunks and k2 >= 3 and track_step.LAUNCHES_V2 == 0,
          (tag, "one K2 launch a chunk", k2, chunks))
    lines, fails = validate(one, RX_SECONDS)
    for ln in lines:
        log(f"[{tag}] one program {ln}")
    check(not fails, (tag, "one program", fails))
    same = total = 0
    text = _rows_text(one)
    for key, rows in per.items():
        check(len(rows) == len(text[key]), (tag, key, len(rows),
                                            len(text[key])))
        a = np.array([r.split() for r in rows], float)
        b = np.array([r.split() for r in text[key]], float)
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-2)
        same += sum(x == y for x, y in zip(rows, text[key]))
        total += len(rows)
    check(same == total, (tag, "rows text-equal to the per-band runs'",
                          same, total))
    log(f"[{tag}] the receiver's rows against the per-band runs': within "
        f"rtol 2e-3 / atol 2e-2 and text-equal, {same} of {total}")
    t0 = time.perf_counter()
    with scans_held_to_plain() as held:
        run_receiver(paths, dev, RX_CHUNK_MS, max_blocks=RX_HELD_BLOCKS)
    check(len(held) == 2 and sum(held) == RX_HELD_BLOCKS, (tag, held))
    log(f"[{tag}] the receiver's own scans of its first {len(held)} chunks "
        f"({held} blocks, the second after the rebase) against the plain "
        f"version on the same arguments: rows, int rows and state "
        f"bit-equal ({time.perf_counter() - t0:.2f} s)  [{card}]")
    t_band = sum(walls.values())
    log(f"[{tag}] walls: per band {', '.join(f'{w:.2f}' for w in walls.values())}"
        f" s ({RX_SECONDS / t_band:.3f} capture seconds a wall second); one "
        f"program {wall:.2f} s ({RX_SECONDS / wall:.3f}); {chunks} chunks, "
        f"{k2} K2 launches; upload {stats['upload_bytes'][0]} bytes "
        f"a chunk; read-wait {stats['t_read']:.2f} s, upload "
        f"{stats['t_upload']:.2f} s, scan and rows "
        f"{stats['t_scan']:.2f} s  [{card}]")
    int8_bytes = stats["upload_bytes"]

    pwall, busy, k2_s, k2_n, top = _receiver_profile(paths, dev, work)
    # K2's bound over the run: each launch's chunk (every band's segment,
    # complex64) read once, each channel's chips, the rows, the samples
    keys = [f"{s}:{p}" for v in BANDS.values() for s, p, *_ in v]
    sigs = [get_signal(k.split(":")[0]) for k in keys]
    samp = [one[k][-1]["samp"] for k in keys]
    chips = chunks * sum(min(g.code_length,
                             int(n * g.chip_rate / FS / chunks) + 3)
                         for g, n in zip(sigs, samp))
    bms, by = k2_bound(chunks * len(BANDS) * stats["seg_cap"], chips,
                       sum(len(one[k]) for k in keys), float(sum(samp)),
                       "subc")
    log(f"[{tag}] profiled: wall {pwall:.2f} s, device busy {busy:.3f} s "
        f"(busy share {busy / pwall:.4f}, idle {1 - busy / pwall:.4f}), K2 "
        f"{k2_n} launches {k2_s * 1e3:.2f} ms of device time "
        f"({sum(samp) / k2_s / 1e9:.4g} G samples/s over {sum(samp)} "
        f"samples; bound {bms:.4f} ms by {by}); largest device events "
        f"{json.dumps(top)}  [{card}]")
    results["track_fused"]["receiver"] = dict(
        seconds=RX_SECONDS, chunks=chunks, launches=k2, wall_s=wall,
        per_band_wall_s=t_band, realtime=RX_SECONDS / wall,
        profiled_wall_s=pwall, busy_s=busy, idle_share=1 - busy / pwall,
        k2_device_ms=k2_s * 1e3, k2_bound_ms=bms, k2_bound_by=by,
        upload_bytes=int8_bytes[0])

    stats = {}
    with environ({"GNSS_DSP_UPLOAD_INT4": "1"}):
        four, wall4 = run_receiver(paths, dev, RX_CHUNK_MS, stats=stats)
    lines, fails = validate(four, RX_SECONDS)
    check(not fails, (tag, "int4", fails, lines))
    got = stats["upload_bytes"]
    check([2 * b for b in got] == int8_bytes, (tag, "int4 bytes", got,
                                               int8_bytes))
    log(f"[{tag}] GNSS_DSP_UPLOAD_INT4: every channel locked, "
        f"{got[0]} bytes a chunk against {int8_bytes[0]}, wall {wall4:.2f} s"
        f"  [{card}]")
    for p in paths.values():
        os.remove(p)

    cpaths = {b: os.path.join(work, f"coh_band{b}.iq") for b in COH_RX}
    roll = {b: [COH_ROLL] * len(s) for b, s in COH_RX.items()}
    synth_bands(cpaths, 1.2, bands=COH_RX, fs=COH_RX_FS, device=dev,
                overlays=roll)
    track_fused.LAUNCHES = 0
    stats = {}
    with recording() as calls:
        crows, cwall = run_receiver(cpaths, dev, RX_CHUNK_MS, bands=COH_RX,
                                    fs=COH_RX_FS, coherent_blocks=-1,
                                    overlay_phase=roll, stats=stats)
    torch.cuda.synchronize()
    check_covered(tag, calls)
    check(track_fused.LAUNCHES == stats["chunks"],
          (tag, "coherent: one K2 launch a chunk"))
    k2 += track_fused.LAUNCHES
    for seeds in COH_RX.values():
        for s, p, dop, *_ in seeds:
            cf = np.array([r["carrier_f"] for r in crows[f"{s}:{p}"][-200:]])
            check(abs(cf.mean() - dop) < 1.0, (tag, s, cf.mean(), dop))
            log(f"[{tag}] coherent {s}:{p}: {len(crows[f'{s}:{p}'])} rows, "
                f"mean carrier_f of the last 200 {cf.mean():.3f} (truth "
                f"{dop}), spread {cf.std():.3f} Hz")
    log(f"[{tag}] coherent receiver {cwall:.2f} s  [{card}]")
    for p in cpaths.values():
        os.remove(p)
    return k2


# --------------------------------------------------------- phase e2e_multi

def phase_e2e_multi(dev, card, work, seconds=1.2):
    """`track multi` through the CLI on each mix of E2E_MULTI (one 1.2 s
    capture at the mix's rate, 45 dB-Hz, tools/receiver_sky.synth_bands),
    loop dwells 200/200, each channel's doppler 3 Hz off: every channel
    within 5 Hz of the truth over the last 200 rows, K2 the route (the
    long-code mix's rows read from device memory); then the TMBOC mix
    under --mesh 2 (two sat shards of the card): rows byte-equal.
    Returns K2's launches."""
    import torch

    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.ops import track_fused
    from gnss_dsp_tpu_torch.tools.main_path import run_cli
    from gnss_dsp_tpu_torch.tools.receiver_sky import synth_bands

    tag = "e2e_multi"
    k2 = 0
    for i, (name, mix, fs) in enumerate(E2E_MULTI):
        path = os.path.join(work, f"multi_{name}.iq")
        synth_bands({0: path}, seconds, bands={0: mix}, fs=fs, device=dev,
                    seed=90 + i)
        spec = ",".join(f"{s}:{p}:{d + 3.0}:{c}:{co}"
                        for s, p, d, c, co in mix)
        argv = ["--loop-dwells", "200,200", path, "%d" % fs, "0", spec,
                "--device", str(dev)]
        track_fused.LAUNCHES = 0
        t0 = time.perf_counter()
        with recording() as calls:
            out = run_cli(trk_cli.main, "multi", argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_covered(tag, calls)
        check(track_fused.LAUNCHES > 0, (tag, name, "K2 not launched"))
        k2 += track_fused.LAUNCHES
        rows = {}
        for line in out.splitlines():
            key, rest = line.split(" ", 1)
            rows.setdefault(key, []).append(rest)
        for s, p, dop, *_ in mix:
            r = rows[f"{s}:{p}"]
            cf = np.array([float(v.split()[3]) for v in r[-200:]])
            df = float(np.abs(cf - dop).max())
            check(len(r) >= 800 and df <= 5.0, (tag, s, p, len(r), df))
            log(f"[{tag}] {name} {s}:{p}: {len(r)} rows, last-200 "
                f"|carrier_f - truth| <= {df:.3f} Hz")
        log(f"[{tag}] {name}: track multi {wall:.2f} s, {track_fused.LAUNCHES}"
            f" K2 launches  [{card}]")
        if i == 0:
            track_fused.LAUNCHES = 0
            with recording() as calls:
                sharded = run_cli(trk_cli.main, "multi",
                                  ["--mesh", "2"] + argv)
            torch.cuda.synchronize()
            check_covered(tag, calls)
            k2 += track_fused.LAUNCHES
            check(sharded == out, (tag, "--mesh 2 rows differ"))
            log(f"[{tag}] {name} --mesh 2 (two sat shards of the card, "
                f"{track_fused.LAUNCHES} K2 launches): rows byte-equal")
        os.remove(path)
    return k2


# ---------------------------------------------------- phase e2e_checkpoint

def phase_e2e_checkpoint(dev, card, work, e2e, blocks=600, stop=250):
    """The track CLI on the e2e GPS L1 capture (8 channels, 8.184 MHz)
    with --chunk-ms 100: an uninterrupted run of `blocks` blocks; a run
    with --checkpoint that stops at `stop` blocks (--blocks, after two
    chunks were checkpointed), then --resume to `blocks`: the rows joined
    at the resumed block byte-equal to the uninterrupted run's.  The
    same with --mesh 2.  Returns K2's launches."""
    import torch

    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.ops import track_fused
    from gnss_dsp_tpu_torch.tools.main_path import run_cli

    tag = "e2e_checkpoint"
    path, fs, specs = e2e[:3]
    ck = os.path.join(work, "track.ck.npz")
    k2 = 0
    for mesh in ([], ["--mesh", "2"]):
        base = mesh + ["--chunk-ms", "100", "--device", str(dev), path,
                       "%d" % fs, "0", specs]
        track_fused.LAUNCHES = 0
        t0 = time.perf_counter()
        with recording() as calls:
            full = run_cli(trk_cli.main, "gps-l1",
                           ["--blocks", str(blocks)] + base).splitlines()
            first = run_cli(trk_cli.main, "gps-l1",
                            ["--blocks", str(stop), "--checkpoint", ck]
                            + base).splitlines()
            check(os.path.exists(ck), (tag, "no checkpoint"))
            rest = run_cli(trk_cli.main, "gps-l1",
                           ["--blocks", str(blocks), "--resume", ck]
                           + base).splitlines()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_covered(tag, calls)
        k2 += track_fused.LAUNCHES
        # each channel resumes at its own block (they stall at the chunk
        # end at different blocks): join channel by channel
        full, first, rest = (_rows_by_prn("\n".join(t))
                             for t in (full, first, rest))
        starts = {}
        for prn, rows in full.items():
            starts[prn] = int(rest[prn][0].split()[0])
            check(0 < starts[prn] < stop, (tag, prn, "resumed at",
                                           starts[prn]))
            joined = [r for r in first[prn]
                      if int(r.split()[0]) < starts[prn]] + rest[prn]
            check(joined == rows, (tag, mesh, prn, "joined rows differ",
                                   len(joined), len(rows)))
        os.remove(ck)
        log(f"[{tag}] {' '.join(mesh) or 'one card'}: stopped at {stop} "
            f"blocks after the checkpoint, resumed at blocks "
            f"{sorted(set(starts.values()))}: {sum(map(len, full.values()))}"
            f" rows of {len(full)} channels joined byte-equal to the "
            f"uninterrupted run's; three CLI runs {wall:.2f} s  [{card}]")
    return k2


# ------------------------------------------------------- phase e2e_recover

def _b2b_capture(path, duo, fs, seconds, seed, dev, cn0=60.0):
    """The duo's satellites [(signal, prn, doppler)] with random
    navigation bits a code period, each at cn0 dB-Hz, synthesised on the
    card and written as int8 I/Q; returns their codes."""
    import torch

    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.tools.track_all import synth_iq_t, write_noisy

    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    x = torch.zeros(n, dtype=torch.complex64, device=dev)
    codes = []
    for name, prn, dop in duo:
        sig = get_signal(name)
        codes.append(sig.code_table((prn,))[0].astype(np.float64))
        bits = rng.choice([-1.0, 1.0], int(seconds * 1000) + 2)
        x += synth_iq_t(sig.code_table((prn,))[0], sig.chip_rate, fs, n, dop,
                        0.0, "none", sig.carrier_ratio, device=dev,
                        data_bits=bits)
    write_noisy(path, x, fs, cn0, seed)
    return codes


def _recovered(path, code):
    """(share of bins visited, chip agreement either sign) of a bins
    file."""
    bins = np.loadtxt(path)
    check(bins.shape == (len(code), 2), ("bins shape", bins.shape))
    rec = np.where(bins[:, 0] >= 0, 1.0, -1.0)
    hit = bins[:, 0] != 0.0
    agree = (rec[hit] == code[hit]).mean()
    return hit.mean(), max(agree, 1.0 - agree)


def phase_e2e_recover(dev, card, work, fs=22.0e6):
    """Unknown-code recovery on the card (the plain scan on CUDA tensors,
    the reference's route; no kernel launches): the B2bI track CLI at 22
    MHz over 300 ms at 60 dB-Hz with data bits, warm-up 10: > 95% of the
    bins visited, the chips > 98% the planted code (either sign); a
    second run writes the same bins; `track multi --recover` on B2bI +
    B2bQ (150 ms) recovers both codes in one pass (> 97%); --mesh 2 (two
    sat shards of the card) writes the single run's bins."""
    import torch

    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.ops import track_fused, track_step
    from gnss_dsp_tpu_torch.tools.main_path import run_cli

    tag = "e2e_recover"
    duo = [("beidou-b2bi", 19, 800.0), ("beidou-b2bq", 20, -1500.0)]
    path = os.path.join(work, "b2bi.iq")
    codes = _b2b_capture(path, duo[:1], fs, 0.3, 101, dev)
    n0 = (track_fused.LAUNCHES, track_step.LAUNCHES_V2,
          track_step.LAUNCHES_V1)
    bins, walls = [], []
    for k, mesh in enumerate(([], [], ["--mesh", "2"])):
        bins.append(os.path.join(work, f"b2bi-chips-{k}.dat"))
        t0 = time.perf_counter()
        rows = run_cli(trk_cli.main, "beidou-b2bi", mesh + [
            "--loop-dwells", "10,10", "--recover-warmup", "10",
            "--recover-file", bins[-1], "--device", str(dev), path,
            "%d" % fs, "0", "19", "800", "0"]).splitlines()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(len(rows) >= 280, (tag, "rows", len(rows)))
    hit, agree = _recovered(bins[0], codes[0])
    check(hit > 0.95 and agree > 0.98, (tag, "b2bi", hit, agree))
    texts = [open(b).read() for b in bins]
    check(texts[1] == texts[0], (tag, "two runs' bins differ"))
    check(texts[2] == texts[0], (tag, "--mesh 2 bins differ"))
    log(f"[{tag}] beidou-b2bi: {hit:.4f} of the bins visited, chips "
        f"{agree:.5f} the planted code; two runs bit-equal, --mesh 2 "
        f"equal; CLI walls {', '.join(f'{w:.2f}' for w in walls)} s for "
        f"300 blocks (the plain scan, many small launches a block)  "
        f"[{card}]")
    os.remove(path)
    path = os.path.join(work, "b2b.iq")
    codes = _b2b_capture(path, duo, fs, 0.15, 102, dev)
    out = os.path.join(work, "chips.dat")
    t0 = time.perf_counter()
    run_cli(trk_cli.main, "multi", [
        "--loop-dwells", "10,10", "--recover", "--recover-warmup", "10",
        "--recover-file", out, "--device", str(dev), path, "%d" % fs, "0",
        ",".join(f"{s}:{p}:{d}:0" for s, p, d in duo)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for (s, p, _), code in zip(duo, codes):
        hit, agree = _recovered(os.path.join(work, f"chips-{s}-{p}.dat"),
                                code)
        check(hit > 0.95 and agree > 0.97, (tag, s, hit, agree))
        log(f"[{tag}] multi --recover {s}:{p}: {hit:.4f} visited, chips "
            f"{agree:.5f}")
    log(f"[{tag}] multi --recover (two codes, one pass) {wall:.2f} s  "
        f"[{card}]")
    check((track_fused.LAUNCHES, track_step.LAUNCHES_V2,
           track_step.LAUNCHES_V1) == n0, (tag, "a kernel launched"))
    os.remove(path)


# ----------------------------------------------------- phase e2e_workload

WORKLOAD_SECONDS = 1.5    # the 2017 sky's capture, as e2e_receiver's
WORKLOAD_HELD_FROM = 1000  # K2 held against the plain version from here
WORKLOAD_HELD = 40


@contextlib.contextmanager
def k2_held_deep(held):
    """Within: every scan track_file runs (track/driver.track_scan) runs
    as it is, and besides, from the state after WORKLOAD_HELD_FROM blocks
    (the pointer tens of millions of samples into a whole-band chunk),
    WORKLOAD_HELD more blocks by K2 and by the plain version on the same
    arguments, rows, int rows and state bit-equal; each scan's shape goes
    into CHECKED and (its pointer, the chunk's length) into `held`."""
    import torch

    from gnss_dsp_tpu_torch.track import driver, engine

    scan = driver.track_scan

    def deep(x, chunk_len, code_tab, state, params, n_blocks, **kw):
        mid = min(WORKLOAD_HELD_FROM, n_blocks - WORKLOAD_HELD)
        s_mid = scan(x, chunk_len, code_tab, state, params, mid, **kw)[0]
        k = scan(x, chunk_len, code_tab, s_mid, params, WORKLOAD_HELD, **kw)
        args, ovl = engine.scan_args(x, chunk_len, code_tab, s_mid, params,
                                     WORKLOAD_HELD, **kw)
        p = engine.track_scan_plain(*args, ovl)
        torch.testing.assert_close(k[2], p[2], rtol=0, atol=0)
        torch.testing.assert_close(k[1], p[1], rtol=0, atol=0,
                                   equal_nan=True)
        for field, a, b in zip(k[0]._fields, k[0], p[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0,
                                       msg=f"state {field}")
        check(bool((k[2][:, :, 0] > 0).all()), "k2 held: a channel stalled")
        CHECKED["track_fused"].append(fused_key(
            "track_fused", x, chunk_len, code_tab, state, params))
        held.append((int(s_mid.ptr.max()), x.shape[0]))
        return scan(x, chunk_len, code_tab, state, params, n_blocks, **kw)

    driver.track_scan = deep
    try:
        yield held
    finally:
        driver.track_scan = scan


def _busy_share(fn):
    """(wall s, device busy s) of fn() under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gnss_dsp_tpu_torch.tools.main_path import device_busy_us

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy_us((e.time_range.start, e.time_range.end)
                          for e in prof.events()
                          if e.device_type == DeviceType.CUDA) / 1e6
    return wall, busy


def phase_e2e_workload(dev, card, results, work):
    """The reference's full workload in one process (cli/workload all:
    acquire-all.sh's 21 acquisitions, track-all-gnss-2017-L1L2L5.sh's 11
    tracks) on the 2017 three-band sky: WORKLOAD_SECONDS at 69.984 MHz
    and 45 dB-Hz, the bands synthesised on the card
    (tools/receiver_sky.synth_bands) and interleaved into the
    tools/synth_sky container.  First the workload's own whole-band
    chunks: each track's K2 scan held against the plain version from
    block WORKLOAD_HELD_FROM (k2_held_deep).  Then the run, the counts
    set to 0 just before and read just after: K1 the only acquisition
    kernel, one K2 launch a track (the band preloaded whole), every launch
    shape held; tools/sky_workload.validate on all 32 files (11 planted
    acquisitions, 11 tracks); each file byte-equal to the same CLI call
    without the cache; the stage walls (stderr), then the run again under
    torch.profiler (busy and idle share; files equal again).  Returns
    (K1 launches, K2 launches)."""
    import torch

    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.cli import workload
    from gnss_dsp_tpu_torch.tools.main_path import run_cli
    from gnss_dsp_tpu_torch.tools.receiver_sky import BANDS, FS, synth_bands
    from gnss_dsp_tpu_torch.tools.sky_workload import (
        output_files, validate, write_container)

    tag = "e2e_workload"
    paths = {b: os.path.join(work, f"wl_band{b}.iq") for b in BANDS}
    t0 = time.perf_counter()
    synth_bands(paths, WORKLOAD_SECONDS, device=dev)
    torch.cuda.synchronize()
    container = os.path.join(work, "sky.pcap")
    frames = write_container(paths, container)
    check(frames == int(WORKLOAD_SECONDS * 1000), (tag, frames))
    log(f"[{tag}] container {container}: {frames} frames x 3 bands at "
        f"69.984 MHz, {os.path.getsize(container)} bytes, bands synthesised "
        f"on the card ({time.perf_counter() - t0:.2f} s)")

    held, cache = [], {}
    t0 = time.perf_counter()
    with k2_held_deep(held):
        for row in workload.TRACK_ALL:
            run_cli(lambda *a: trk_cli.main(*a, x_cache=cache), row[1],
                    workload.track_argv(row, paths[row[0]])
                    + ["--device", str(dev)])
    torch.cuda.synchronize()
    check(len(held) == len(workload.TRACK_ALL), (tag, held))
    log(f"[{tag}] each track's whole-band K2 scan held against the plain "
        f"version for {WORKLOAD_HELD} blocks from block {WORKLOAD_HELD_FROM}"
        f": rows, int rows and state bit-equal; pointers "
        f"{min(p for p, _ in held)}-{max(p for p, _ in held)} into chunks of "
        f"{held[0][1]} samples ({time.perf_counter() - t0:.2f} s)  [{card}]")
    del cache

    dest = os.path.join(work, "workload")
    _zero_counts()
    err = io.StringIO()
    t0 = time.perf_counter()
    with recording() as calls, contextlib.redirect_stderr(err):
        rc = workload.main(["all", container, dest, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    k1, k2 = counts.pop("acquire2"), counts.pop("track_fused")
    check(rc == 0, (tag, "rc", rc))
    for line in err.getvalue().splitlines():
        log(f"[{tag}] {line}  [{card}]")
    check_covered(tag, calls)
    check(k1 > 0 and k2 == len(workload.TRACK_ALL)
          and not any(counts.values()), (tag, "launches", k1, k2, counts))
    lines, fails = validate(dest)
    for ln in lines:
        log(f"[{tag}] {ln}")
    check(not fails, (tag, "validate", fails))
    for b, p in paths.items():
        with open(p, "rb") as f, open(os.path.join(dest, f"band{b}.iq"),
                                      "rb") as g:
            check(f.read() == g.read(), (tag, "demuxed band differs", b))
        os.remove(p)
    log(f"[{tag}] cli.workload all: {wall:.2f} s wall, {k1} K1 launches "
        f"(21 acquisitions), {k2} K2 launches (11 tracks, one a track); "
        f"every planted acquisition and track validated  [{card}]")

    texts = {}
    for fn in output_files():
        with open(os.path.join(dest, fn)) as f:
            texts[fn] = f.read()
    t_un = {}
    same = 0
    for row in workload.ACQUIRE_ALL + workload.TRACK_ALL:
        band = os.path.join(dest, f"band{row[0]}.iq")
        if len(row) == 4:
            main, argv, fn = acq_cli.main, workload.acquire_argv(row, band), \
                row[3]
        else:
            main, argv, fn = trk_cli.main, workload.track_argv(row, band), \
                row[6]
        t1 = time.perf_counter()
        out = run_cli(main, row[1], argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        t_un[fn] = time.perf_counter() - t1
        check(out == texts[fn], (tag, fn, "differs from the uncached call"))
        same += 1
    log(f"[{tag}] all {same} files byte-equal to the same CLI call without "
        f"the cache; uncached walls: acquisitions "
        f"{sum(t_un[r[3]] for r in workload.ACQUIRE_ALL):.2f} s, tracks "
        f"{sum(t_un[r[6]] for r in workload.TRACK_ALL):.2f} s "
        f"({json.dumps({k: round(v, 3) for k, v in t_un.items()})})  "
        f"[{card}]")

    dest2 = os.path.join(work, "workload_profiled")
    err2 = io.StringIO()
    with contextlib.redirect_stderr(err2):
        pwall, busy = _busy_share(lambda: workload.main(
            ["all", container, dest2, "--device", str(dev)]))
    for fn, text in texts.items():
        with open(os.path.join(dest2, fn)) as f:
            check(f.read() == text, (tag, fn, "second run differs"))
    stages = [ln for ln in err2.getvalue().splitlines()
              if "acquire-all" in ln or "track-all" in ln]
    log(f"[{tag}] profiled run: wall {pwall:.2f} s, device busy {busy:.3f} "
        f"s (busy share {busy / pwall:.4f}, idle {1 - busy / pwall:.4f}); "
        f"{'; '.join(stages)}; files equal to the first run's  [{card}]")
    results["acquire2"]["workload"] = dict(launches=k1, wall_s=wall)
    results["track_fused"]["workload"] = dict(
        launches=k2, wall_s=wall, profiled_wall_s=pwall, busy_s=busy,
        idle_share=1 - busy / pwall)
    for d in (dest, dest2):
        for b in BANDS:
            os.remove(os.path.join(d, f"band{b}.iq"))
    os.remove(container)
    return k1, k2


# ----------------------------------------------------- phase e2e_switches

@contextlib.contextmanager
def plain_routes():
    """Yields a dict counting the calls of the kernel-free routes: the
    plain surface of the xla route (ops/acquire.corr_surface_plain, as
    acquire/engine calls it) and the plain scan (track/engine.
    track_scan_plain, as track_scan calls it)."""
    from gnss_dsp_tpu_torch.ops import acquire
    from gnss_dsp_tpu_torch.track import engine

    seen = {"surface": 0, "scan": 0}
    saved = [(acquire, "corr_surface_plain", "surface"),
             (engine, "track_scan_plain", "scan")]
    origs = [getattr(m, f) for m, f, _ in saved]
    for (m, f, key), orig in zip(saved, origs):
        def spy(*a, _orig=orig, _key=key, **kw):
            seen[_key] += 1
            return _orig(*a, **kw)
        setattr(m, f, spy)
    try:
        yield seen
    finally:
        for (m, f, _), orig in zip(saved, origs):
            setattr(m, f, orig)


def _kernel_counts():
    from gnss_dsp_tpu_torch.ops import (acquire, acquire2, acquire_coh,
                                        track_fused, track_step)

    return dict(acquire2=acquire2.LAUNCHES, acquire=acquire.LAUNCHES,
                surface=acquire2.LAUNCHES_SURFACE,
                spec=acquire_coh.LAUNCHES_SPEC, blk=acquire_coh.LAUNCHES_BLK,
                track_fused=track_fused.LAUNCHES,
                step_v2=track_step.LAUNCHES_V2,
                step_v1=track_step.LAUNCHES_V1)


def _zero_counts():
    """Every kernel wrapper's launch count (_kernel_counts) set to 0."""
    from gnss_dsp_tpu_torch.ops import (acquire, acquire2, acquire_coh,
                                        track_fused, track_step)

    acquire2.LAUNCHES = acquire.LAUNCHES = acquire2.LAUNCHES_SURFACE = 0
    acquire_coh.LAUNCHES_SPEC = acquire_coh.LAUNCHES_BLK = 0
    track_fused.LAUNCHES = 0
    track_step.LAUNCHES_V2 = track_step.LAUNCHES_V1 = 0
    check(not any(_kernel_counts().values()), _kernel_counts())


def _delta(before):
    return {k: v - before[k] for k, v in _kernel_counts().items()}


def phase_e2e_switches(dev, card, results, work, e2e):
    """The reference's route switches through the CLIs on the card.
    GNSS_DSP_NO_V2P: gps-l5i's acquisition (an 85 ms capture at 30.69
    MHz) takes K7 at 61380 (counted by its wrapper and by torch.profiler)
    and no K1, with the v2p route's winners.  GNSS_DSP_NO_PALLAS: GPS L1
    acquire (also --coherent 2 and --mesh 1), track (300 blocks) and
    track multi on the e2e capture each raise the refusal that names the
    switch, with no kernel launched and no plain route called.  Unset: K1
    and K2 launch and the plain routes are never called.  Returns K7's
    launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.tools.main_path import (
        environ, parse_hits, run_cli, synth_at_acq_fs)

    tag = "e2e_switches"
    path = os.path.join(work, "switch_gps_l5i.iq")
    truth = synth_at_acq_fs(path, "gps-l5i", 0.085, seed=70)
    args = ["--time", "80", path, str(truth["fs"]), "0", "--device",
            str(dev)]
    n0 = _kernel_counts()
    with plain_routes() as plain:
        t0 = time.perf_counter()
        v2p = parse_hits(run_cli(acq_cli.main, "gps-l5i", list(args)))
        torch.cuda.synchronize()
        t_v2p = time.perf_counter() - t0
    d = _delta(n0)
    check(d["acquire2"] > 0 and d["acquire"] == 0 and plain["surface"] == 0,
          (tag, "unset gps-l5i", d, plain))
    n0 = _kernel_counts()
    with environ({"GNSS_DSP_NO_V2P": "1"}), recording() as calls, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        v1 = parse_hits(run_cli(acq_cli.main, "gps-l5i", list(args)))
        torch.cuda.synchronize()
        t_v1 = time.perf_counter() - t0
    d = _delta(n0)
    k7 = d["acquire"]
    seen = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and "full_kernel" in e.name)
    check(k7 > 0 and d["acquire2"] == 0 and 0 < seen <= k7,
          (tag, "NO_V2P: K7 not the route", d, seen))
    check_covered(tag, calls)
    check_hits("gps-l5i NO_V2P", v1, truth, 200.0, phase=tag)
    for prn in truth["prns"]:
        check((v1[prn]["doppler"], v1[prn]["code"])
              == (v2p[prn]["doppler"], v2p[prn]["code"]),
              (tag, prn, v1[prn], v2p[prn]))
    log(f"[{tag}] GNSS_DSP_NO_V2P gps-l5i: K7 at 61380, {k7} launches "
        f"(profiler: {seen} kernel events), no K1; planted winners equal to "
        f"the v2p route's; acquire CLI {t_v1:.2f} s against {t_v2p:.2f} s "
        f"on K1's v2p  [{card}]")
    os.remove(path)

    path, fs, specs, k2_out, _truth = e2e
    acq = [path, str(fs), "0", "--device", str(dev)]
    trk = ["--blocks", "300", "--device", str(dev), path, str(fs), "0", specs]
    n0 = _kernel_counts()
    with plain_routes() as plain:
        t0 = time.perf_counter()
        a = run_cli(acq_cli.main, "gps-l1", list(acq))
        torch.cuda.synchronize()
        t_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        t = run_cli(trk_cli.main, "gps-l1", list(trk))
        torch.cuda.synchronize()
        t_t = time.perf_counter() - t0
    d = _delta(n0)
    check(d["acquire2"] > 0 and d["track_fused"] == 1
          and plain == {"surface": 0, "scan": 0},
          (tag, "unset: not the kernel routes", d, plain))
    hits, want = parse_hits(a), _rows_by_prn(k2_out)
    for prn, rows in _rows_by_prn(t).items():
        check(rows == want[prn][:len(rows)], (tag, "unset rows", prn))
    k1_unset, k2_unset = d["acquire2"], d["track_fused"]
    refused = []
    calls = [("acquire", acq_cli.main, "gps-l1", acq),
             ("acquire --coherent 2", acq_cli.main, "gps-l1",
              ["--coherent", "2"] + acq),
             ("acquire --mesh 1", acq_cli.main, "gps-l1",
              ["--mesh", "1"] + acq),
             ("track", trk_cli.main, "gps-l1", trk),
             ("track multi", trk_cli.main, "multi",
              ["--blocks", "30", "--device", str(dev), path, str(fs), "0",
               "gps-l1:" + specs.split(",")[0]])]
    n0 = _kernel_counts()
    with environ({"GNSS_DSP_NO_PALLAS": "1"}), plain_routes() as plain:
        for label, main, signal, argv in calls:
            try:
                run_cli(main, signal, list(argv))
            except RuntimeError as e:
                check("GNSS_DSP_NO_PALLAS" in str(e), (tag, label, str(e)))
                refused.append(label)
        torch.cuda.synchronize()
    d = _delta(n0)
    check(refused == [c[0] for c in calls] and not any(d.values())
          and plain == {"surface": 0, "scan": 0},
          (tag, "NO_PALLAS not refused on the card", refused, d, plain))
    log(f"[{tag}] GNSS_DSP_NO_PALLAS on the card: {', '.join(refused)} each "
        f"refused, naming the switch; no kernel launched, no plain route "
        f"called.  Unset: K1 {k1_unset} launches / K2 {k2_unset}, no plain "
        f"route, the rows K2's of phase e2e, {len(hits)} PRNs searched; "
        f"walls acquire {t_a:.2f} s / track {t_t:.2f} s  [{card}]")
    _cpu_switch(dev, card, e2e, trk, t)
    _timing_split(dev, card, e2e, acq, a)
    results["acquire_61380"]["launches"] += k7
    results["acquire_61380"]["single_card"]["launches"] = k7
    return k7


def _cli_err(main, signal, argv):
    """(stdout, stderr) of a CLI call in this process."""
    from gnss_dsp_tpu_torch.tools.main_path import run_cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = run_cli(main, signal, list(argv))
    return out, err.getvalue()


def _cpu_switch(dev, card, e2e, trk, t):
    """GNSS_DSP_CPU on the card's machine, set only inside this block:
    the GPS L1 acquire CLI (three planted PRNs) and track CLI (100
    blocks) without --device run on the CPU, their rows those of
    --device cpu, no kernel launched, one stderr line naming the switch
    each; with --device cuda they run on the card as unset (K1 once, K2
    once for `trk`'s 300 blocks, the rows the unset card run's `t`)."""
    import torch

    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.tools.main_path import environ, run_cli

    tag = "e2e_switches"
    path, fs, specs, _out, truth = e2e
    prns = ["--prn", ",".join(str(p) for p in truth["prns"][:3])]
    sub = prns + [path, str(fs), "0"]
    trk_nodev = ["--blocks", "100", path, str(fs), "0", specs]
    card_acq = run_cli(acq_cli.main, "gps-l1", sub + ["--device", str(dev)])
    with environ({"GNSS_DSP_CPU": "1"}):
        n0 = _kernel_counts()
        t0 = time.perf_counter()
        a_sw, err_a = _cli_err(acq_cli.main, "gps-l1", sub)
        t_t0 = time.perf_counter()
        t_sw, err_t = _cli_err(trk_cli.main, "gps-l1", trk_nodev)
        t_cpu = time.perf_counter()
        d = _delta(n0)
        check(not any(d.values()), (tag, "GNSS_DSP_CPU launched kernels", d))
        for label, err in (("acquire", err_a), ("track", err_t)):
            named = [ln for ln in err.splitlines() if "GNSS_DSP_CPU" in ln]
            check(len(named) == 1, (tag, label, "stderr", err))
            log(f"[{tag}] GNSS_DSP_CPU {label} stderr: {named[0]}")
        a_cpu, err = _cli_err(acq_cli.main, "gps-l1", sub + ["--device",
                                                              "cpu"])
        t_cpu_rows, err2 = _cli_err(trk_cli.main, "gps-l1",
                                    trk_nodev + ["--device", "cpu"])
        check("GNSS_DSP_CPU" not in err + err2, (tag, err, err2))
        check(a_sw == a_cpu and t_sw == t_cpu_rows,
              (tag, "GNSS_DSP_CPU rows differ from --device cpu"))
        n0 = _kernel_counts()
        a_cu = run_cli(acq_cli.main, "gps-l1", sub + ["--device", str(dev)])
        t_cu = run_cli(trk_cli.main, "gps-l1", list(trk))
        torch.cuda.synchronize()
        d = _delta(n0)
    check(d["acquire2"] == 1 and d["track_fused"] == 1
          and sum(d.values()) == 2, (tag, "--device cuda", d))
    check(a_cu == card_acq and t_cu == t,
          (tag, "--device cuda under GNSS_DSP_CPU: rows differ"))
    log(f"[{tag}] GNSS_DSP_CPU: acquire (3 PRNs) and "
        f"track (100 blocks) on the CPU, no kernel launched, rows equal to "
        f"--device cpu (walls {t_t0 - t0:.2f} s / {t_cpu - t_t0:.2f} s); "
        f"--device cuda wins: K1 {d['acquire2']}, K2 {d['track_fused']} "
        f"launches, rows the unset card run's  [{card}]")


def _timing_split(dev, card, e2e, acq, a):
    """GNSS_DSP_TIMING on the card: the GPS L1 acquire CLI (all 32 PRNs)
    and the track CLI (2150 blocks, two chunks) print the reference's
    stage walls, their rows byte-equal to the unset runs'."""
    import torch

    from gnss_dsp_tpu_torch.cli import acquire as acq_cli
    from gnss_dsp_tpu_torch.cli import track as trk_cli
    from gnss_dsp_tpu_torch.tools.main_path import environ

    tag = "e2e_switches"
    path, fs, specs, k2_out, _truth = e2e
    trk = ["--blocks", "2150", "--device", str(dev), path, str(fs), "0",
           specs]
    with environ({"GNSS_DSP_TIMING": "1"}):
        for label, main, signal, argv, want in (
                ("acquire", acq_cli.main, "gps-l1", acq, a),
                ("track", trk_cli.main, "gps-l1", trk, k2_out)):
            t0 = time.perf_counter()
            out, err = _cli_err(main, signal, argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lines = [ln for ln in err.splitlines() if "timing]" in ln]
            check(out == want and lines,
                  (tag, "GNSS_DSP_TIMING", label, err))
            log(f"[{tag}] GNSS_DSP_TIMING gps-l1 {label} on the card (wall "
                f"{wall:.3f} s, rows equal to the unset run's): "
                f"{' | '.join(lines)}  [{card}]")


# ---------------------------------------------------------- phase e2e_aux

def _binary_cli(main, argv, out):
    """main(argv) writing binary to sys.stdout.buffer, into `out`."""
    import types

    with open(out, "wb") as f:
        saved = sys.stdout
        sys.stdout = types.SimpleNamespace(buffer=f)
        try:
            rc = main(argv)
        finally:
            sys.stdout = saved
    check(rc == 0, (main.__module__, rc))
    return np.fromfile(out, np.int16)


def phase_e2e_aux(dev, card, work, e2e):
    """The aux tools on the card: the squaring CLI on a 4-round capture
    (a weak tone in noise at an int8 level where 20 r stays inside
    int16, 4 MHz, carrier offset 2.5 kHz) against --device cpu: int16
    equal, or one LSB apart where the CPU's unrounded 20 r lies within
    float32 rounding (1e-5 relative) of a .5 tie (counted);
    correlation_shape on a block of the e2e capture (320 lags at 0.0125
    chips, cboc) against the CPU, rtol 1e-5 / atol 1e-6 n;
    utils/profiling.trace around a squaring call writes its trace with
    the card's kernels in it."""
    import torch

    from gnss_dsp_tpu_torch.cli import squaring as sq_cli
    from gnss_dsp_tpu_torch.models import get_signal
    from gnss_dsp_tpu_torch.ops.frontend import mix_long
    from gnss_dsp_tpu_torch.ops.squaring import squaring
    from gnss_dsp_tpu_torch.track.probe import correlation_shape
    from gnss_dsp_tpu_torch.utils.profiling import device_sync, trace

    tag = "e2e_aux"
    path, fs = e2e[0], e2e[1]
    rounds, sq_fs, coff = 4, 4.0e6, 2500.0
    per = sq_cli.B * sq_cli.N * sq_cli.M
    rng = np.random.default_rng(15)
    n = rounds * per + 999
    t = np.arange(n)
    x = 0.3 * np.exp(2j * np.pi * 3000.0 * t / sq_fs) + 2 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iq = np.empty(2 * n, np.int8)
    iq[0::2] = np.clip(np.round(x.real), -127, 127)
    iq[1::2] = np.clip(np.round(x.imag), -127, 127)
    sq_path = os.path.join(work, "squaring.iq")
    iq.tofile(sq_path)
    walls = {}
    got = {}
    for d in (str(dev), "cpu"):
        t0 = time.perf_counter()
        got[d] = _binary_cli(sq_cli.main, [sq_path, str(sq_fs), str(coff),
                                           "--device", d],
                             os.path.join(work, f"sq_{d[:3]}.bin"))
        walls[d] = time.perf_counter() - t0
    a, b = got[str(dev)].astype(np.int32), got["cpu"].astype(np.int32)
    check(a.shape == b.shape == (2 * sq_cli.B * rounds,), (tag, a.shape))
    check(np.abs(b).max() < 16000, (tag, "20 r leaves int16"))
    r20, ph = [], 0.0
    for k in range(rounds):
        seg = iq[2 * k * per: 2 * (k + 1) * per].astype(np.float32)
        xs = torch.from_numpy(seg.view(np.complex64).copy())
        r = squaring(mix_long(xs, -coff / sq_fs, ph), sq_cli.N,
                     sq_cli.M).numpy()
        ph = float(np.mod(ph - per * coff / sq_fs, 1))
        r20.append(np.stack([20 * r.real, 20 * r.imag], 1).reshape(-1))
    r20 = np.concatenate(r20)
    check((np.round(r20).astype(np.int32) == b).all(),
          (tag, "the CPU CLI's rounding"))
    diff = np.flatnonzero(a != b)
    off = np.abs(np.abs(r20 - np.floor(r20)) - 0.5)
    check((np.abs(a - b) <= 1).all()
          and (off[diff] <= 1e-5 * np.abs(r20[diff]) + 1e-4).all(),
          (tag, "card and CPU differ past a rounding tie",
           a[diff][:8], b[diff][:8], r20[diff][:8]))
    log(f"[{tag}] squaring CLI on the card: {rounds} rounds, int16 equal to "
        f"--device cpu but {len(diff)} of {a.size} values one LSB apart, "
        f"each at a rounding tie of 20 r; walls {walls[str(dev)]:.2f} s "
        f"card, {walls['cpu']:.2f} s cpu  [{card}]")
    os.remove(sq_path)
    sig = get_signal("galileo-e1b")
    raw = np.fromfile(path, np.int8, count=2 * 16368)
    x = torch.from_numpy(raw.astype(np.float32).view(np.complex64))
    code = torch.from_numpy(sig.code_table((11,))[0].astype(np.int8))
    args = (4090.3, np.float32(sig.chip_rate / fs), 0.0125, 320, 4092,
            "cboc")
    c_dev = correlation_shape(x.to(dev), code.to(dev), *args)
    c_cpu = correlation_shape(x, code, *args)
    check(c_dev.device.type == "cuda", (tag, c_dev.device))
    torch.testing.assert_close(c_dev.cpu(), c_cpu, rtol=1e-5,
                               atol=1e-6 * x.shape[0])
    err = float((c_dev.cpu() - c_cpu).abs().max())
    log(f"[{tag}] correlation_shape on the card: 320 lags x {x.shape[0]} "
        f"samples within rtol 1e-5 of the CPU's (max |d| {err:.3g})")
    tdir = os.path.join(work, "aux_trace")
    xs = torch.from_numpy(np.fromfile(path, np.int8, count=2 * 1600000)
                          .astype(np.float32).view(np.complex64)).to(dev)
    with trace(tdir):
        r = squaring(xs, 16, 100)
        device_sync(r)
    tfile = os.path.join(tdir, "trace.json")
    with open(tfile) as f:
        text = f.read()
    check('"cat": "kernel"' in text or '"cat":"kernel"' in text,
          (tag, "no kernel in the trace"))
    log(f"[{tag}] profiling.trace wrote {tfile} ({len(text)} bytes, the "
        f"card's kernels in it)")
    for d in got:
        os.remove(os.path.join(work, f"sq_{d[:3]}.bin"))


# ------------------------------------------------------ phase e2e_sensitivity

SENS_CPU_POINTS = (28, 34)     # held against the CPU's plain versions


def phase_e2e_sensitivity(dev, card):
    """The sensitivity curve on the card (tools/sensitivity_curve's
    default: BeiDou B1I at 4.096 MHz, 6 C/N0 points x 10 trials, K1 and
    K6 at W = 8192), every launch at a shape phase k1 or k6 checked;
    then the same tool on the CPU (the plain versions) at 28 and 34
    dB-Hz on the same captures: each trial's winning cells equal (metric
    within rtol 1e-4) and its lock decisions equal, but where the card's
    and the CPU's cells differ at a near tie (metrics within rtol 1e-4),
    printed, at most one a point.  Coherent locks 10/10 at 34 dB-Hz and
    at least the non-coherent locks over the curve.  Returns (K1, K6)
    launches."""
    from gnss_dsp_tpu_torch.tools import sensitivity_curve as sc

    tag = "e2e_sensitivity"
    t0 = time.perf_counter()
    text = io.StringIO()
    _zero_counts()
    with recording() as calls, contextlib.redirect_stdout(text):
        curve = sc.run(device=dev)
    counts = _kernel_counts()
    t_card = time.perf_counter() - t0
    check_covered(tag, calls)
    n = len(curve.trials)
    check(counts["acquire2"] == n and counts["blk"] == n
          and sum(counts.values()) == 2 * n, (tag, "launches", counts))
    for line in text.getvalue().splitlines():
        log(f"[{tag}] {line}")
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = sc.run(device="cpu", searched=SENS_CPU_POINTS)
    t_cpu = time.perf_counter() - t1
    ties = {p: 0 for p in SENS_CPU_POINTS}
    for k, (g, c) in enumerate(zip(curve.trials, cpu.trials)):
        check((g.cn0, g.code_phase, g.doppler, g.roll)
              == (c.cn0, c.code_phase, c.doppler, c.roll), (tag, k))
        if c.cn0 not in SENS_CPU_POINTS:
            continue
        tied = False
        for kind in ("nc", "co"):
            a, b = getattr(g, kind), getattr(c, kind)
            cell = ((a.doppler, a.code_offset, getattr(a, "align", 0))
                    == (b.doppler, b.code_offset, getattr(b, "align", 0)))
            check(abs(a.metric - b.metric) <= 1e-4 * abs(b.metric),
                  (tag, k, kind, "metric", a, b))
            if not cell:
                tied = True
                log(f"[{tag}] trial {k} ({c.cn0} dB-Hz) {kind}: near tie, "
                    f"card {a} against CPU {b}")
        if tied:
            ties[c.cn0] += 1
        else:
            check((g.lock_nc, g.lock_co) == (c.lock_nc, c.lock_co),
                  (tag, k, "lock decisions differ"))
    check(all(v <= 1 for v in ties.values()), (tag, "near ties", ties))
    rows = {cn0: (hn, hc) for cn0, hn, hc, _ in curve.rows}
    check(rows[34][1] == curve.trials_per_point,
          (tag, "coherent locks at 34 dB-Hz", rows[34]))
    check(sum(v[1] for v in rows.values())
          >= sum(v[0] for v in rows.values()), (tag, "no gain", rows))
    held = sum(c.cn0 in SENS_CPU_POINTS for c in cpu.trials)
    log(f"[{tag}] {n} trials: K1 {counts['acquire2']} and K6 "
        f"{counts['blk']} launches, every launch shape checked; the CPU's "
        f"plain versions on the same {held} "
        f"trials at {SENS_CPU_POINTS} dB-Hz: the same cells and lock "
        f"decisions (near ties {ties}); coherent locks "
        f"{sum(v[1] for v in rows.values())} against non-coherent "
        f"{sum(v[0] for v in rows.values())}; wall {t_card:.2f} s on the "
        f"card, {t_cpu:.2f} s on the CPU  [{card}]")
    return counts["acquire2"], counts["blk"]


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("_work", "smoke"),
                    help="scratch directory for the synthetic capture")
    args = ap.parse_args(argv)
    if os.environ.get("GNSS_DSP_CPU"):
        # the port's CLIs would run on the CPU: this script holds the card
        print("chip_smoke: GNSS_DSP_CPU is set, which pins the port's CLIs "
              "to the CPU; unset it to run on the card", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from gnss_dsp_tpu_torch.device import resolve_device
    from gnss_dsp_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    results = {k: dict(name=k, **v, launches=0, max_abs_err=None, ms=None,
                       plain_ms=None, bound_ms=None, bound_by=None,
                       library_ms=None) for k, v in KERNELS.items()}
    log(f"[device] {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    _build.load()
    info = _build.BUILD_INFO
    log(f"[build] {os.path.basename(info['path'])} in "
        f"{info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "error" in line or "smem" in line:
            log(f"[build] {line.strip()}")
    for name, v in _build.ptxas_summary(info["log"], CLUSTER_KERNELS).items():
        log(f"[build] cluster kernel {name}: {v}")
    os.makedirs(args.out, exist_ok=True)
    phase_k1(dev, card, results)
    phase_k1s(dev, card, results)
    phase_k7(dev, card, results)
    phase_k5(dev, card, results)
    phase_k6(dev, card, results)
    phase_k2(dev, card, results)
    phase_k2_main_path(dev, results, args.out)
    phase_k3(dev, card, results)
    phase_k4(dev, card, results)
    phase_track_rows(dev, card, results)
    phase_k2_slice(dev, card, results)
    e2e = phase_e2e(dev, card, results, args.out)
    phase_gps_l1_routes(dev, card, results, e2e)
    k2_slice = {"e2e_checkpoint": phase_e2e_checkpoint(dev, card, args.out,
                                                       e2e)}
    k2_fams, k3 = phase_e2e_track(dev, card, args.out)
    results["track_step_v2"]["launches"] += k3
    phase_e2e_coherent(dev, card, results, args.out)
    coh, b1i_track = phase_e2e_coherent_track(dev, card, args.out)
    k2_fams.update((k, v[0]) for k, v in coh.items())
    log(f"[k2] launches: e2e {results['track_fused']['launches']}, "
        f"e2e_track and e2e_coherent_track {json.dumps(k2_fams)}")
    results["track_fused"]["launches"] += sum(k2_fams.values())
    os.remove(phase_e2e_mesh(dev, card, results, args.out, e2e, b1i_track))
    phase_e2e_switches(dev, card, results, args.out, e2e)
    phase_e2e_aux(dev, card, args.out, e2e)
    os.remove(e2e[0])
    k1_wide = phase_e2e_wide(dev, card, results, args.out)
    log(f"[e2e_wide] acquire2 launches: e2e {results['acquire2']['launches']}"
        f", e2e_wide {k1_wide}")
    results["acquire2"]["launches"] += k1_wide
    k5_wide = phase_e2e_coherent_wide(dev, card, args.out)
    k5_track = sum(v[1] for v in coh.values())
    log(f"[e2e_coherent_wide] acquire_coh_spec launches: e2e_coherent "
        f"{results['acquire_coh_spec']['launches']}, e2e_coherent_track "
        f"{k5_track}, e2e_coherent_wide {k5_wide}")
    results["acquire_coh_spec"]["launches"] += k5_track + k5_wide
    phase_e2e_fdma(dev, card, results, args.out)
    phase_e2e_serial(dev, card, args.out)
    k2_slice["e2e_receiver"] = phase_e2e_receiver(dev, card, results,
                                                  args.out)
    k2_slice["e2e_multi"] = phase_e2e_multi(dev, card, args.out)
    phase_e2e_recover(dev, card, args.out)
    k1_sens, k6_sens = phase_e2e_sensitivity(dev, card)
    log(f"[e2e_sensitivity] launches: acquire2 {k1_sens}, acquire_coh "
        f"{k6_sens}")
    results["acquire2"]["launches"] += k1_sens
    results["acquire_coh"]["launches"] += k6_sens
    k1_wl, k2_slice["e2e_workload"] = phase_e2e_workload(dev, card, results,
                                                        args.out)
    log(f"[e2e_workload] acquire2 launches: {k1_wl}")
    results["acquire2"]["launches"] += k1_wl
    log(f"[k2] launches: {json.dumps(k2_slice)}")
    results["track_fused"]["launches"] += sum(k2_slice.values())
    for r in results.values():
        need = ["launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by"] + (["library_ms"] if r["name"] not in NO_LIBRARY
                               else [])
        check(all(r[k] is not None for k in need) and r["launches"] > 0,
              ("kernel line incomplete", r))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    check(not [m for m in sys.modules if m in ("jax", "gnss_dsp_tpu")
               or m.startswith(("jax.", "gnss_dsp_tpu."))],
          "jax or the JAX package was imported")
    print(json.dumps({"kernels": list(results.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
