"""gnss_dsp_tpu_torch — the PyTorch/CUDA port of gnss_dsp_tpu.

The JAX package (`gnss_dsp_tpu`) stays the reference; this package runs
the GPS L1 C/A main path (acquire -> track -> C/N0), non-coherent
acquisition of every CDMA signal with an FFT search, tracking of every
signal with a code table, and extended-coherent acquisition and tracking
on an NVIDIA Hopper card through hand-written CUDA kernels:

  ops/acquire2.py     non-coherent acquisition surface with in-kernel
                      (max, argmax, sum) reduction  (csrc/acquire2.cu)
  ops/acquire.py      the full non-coherent surface, for the windows
                      without an aligned split  (csrc/acquire.cu)
  ops/acquire_coh.py  extended-coherent surfaces  (csrc/acquire_coh.cu)
  ops/track_fused.py  the whole tracking loop, all blocks in one launch
                      (csrc/track_fused.cu)
  ops/track_step.py   one tracking step's E/P/L sums, the per-step route
                      (csrc/track_step.cu)

Every kernel has a plain PyTorch version; the port takes the plain
version only for a tensor that lies on the CPU.  The layout mirrors the
JAX package (ops/, acquire/, track/, cli/, models/, utils/) so each
module's counterpart is easy to find; tools/ holds the main-path
scenario and its profiler.  The host tier the port needs from the
reference (models/: signal catalog and code tables with their ICD data;
utils/ranges.py, utils/synth.py, cli/cn0.py) is a copy of the JAX
package's numpy-only modules, held bit for bit against them by
tests/test_torch_models.py: nothing here imports jax or gnss_dsp_tpu.
"""

__version__ = "0.1.0"
