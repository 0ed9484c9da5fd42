"""gnss_dsp_tpu_torch — the PyTorch/CUDA port of gnss_dsp_tpu.

The JAX package (`gnss_dsp_tpu`) stays the reference; this package runs
the same GPS L1 C/A main path (acquire -> track -> C/N0) on an NVIDIA
Hopper card through two hand-written CUDA kernels:

  ops/acquire2.py     non-coherent acquisition surface with in-kernel
                      (max, argmax, sum) reduction  (csrc/acquire2.cu)
  ops/track_fused.py  the whole tracking loop, all blocks in one launch
                      (csrc/track_fused.cu)

Every kernel has a plain PyTorch version; the port takes the plain
version only for a tensor that lies on the CPU (acquire2.corr_surface2
and track/engine.track_scan choose by the tensor's device).  The layout
mirrors the JAX package (ops/, acquire/, track/, cli/, utils/) so each
module's counterpart is easy to find; tools/ holds the main-path
scenario and its profiler.  The JAX-free host tier of the reference
(signal catalog and code tables, sample I/O, synthesis, range parsing,
cli.cn0) is imported from gnss_dsp_tpu, never copied; nothing here
imports jax.
"""

__version__ = "0.1.0"
