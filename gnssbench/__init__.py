"""The benchmark of the PyTorch/CUDA port (gnss_dsp_tpu_torch) on the card.

    python3 -m gnssbench.run --workload CELL --seed N --seconds S --trace 0|1

BENCHMARK.json at the checkout's root names the cells; everything a
cell, a traffic mix or a metric needs is a file of its own here, found
by that name (run.py says where).  The yardstick lives here too, frozen
so that a change to the program cannot move it: the device synthesis
(synth.py), the roofline arithmetic (roofline.py), the trace reading
(devtrace.py) and the plain reference (reference/), which imports
nothing of the program.  Nothing here imports JAX or the JAX package.
"""
