"""The plain reference the benchmark judges the program's outputs by.

It imports nothing of the program (gnss_dsp_tpu_torch), nor JAX or the
JAX package.  Frozen copies, each naming its origin in its header, all
of commit 196026d: models/ (the signal catalog and code generators,
gnss_dsp_tpu_torch/models with utils/ranges.py and the ICD tables;
changed: imports, the self-test entries and their hash file left out)
and track/ (the plain tracking scan: track/engine.py, ops/track_step.py's
plain correlators, ops/nco.py, ops/discriminators.py, utils/twofloat.py,
and the set-up of track/driver.py; changed: imports, the kernel routes
left out, the correlator sums' precision a parameter).  acquire.py is
written for the benchmark from the acquire scripts' semantics.
"""
