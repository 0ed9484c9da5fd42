# Frozen copy of gnss_dsp_tpu_torch/models/__init__.py at commit 196026d.
# Changed: imports point at gnssbench.reference.models.
"""Signal models: descriptors + PRN code-table builders.

A *signal descriptor* captures everything the engines need to acquire and
track one GNSS signal — the reference encodes the same information across
65 near-identical scripts plus 30 signal modules (SURVEY.md §2.2-2.4).
"""

from gnssbench.reference.models.signal import Signal, REGISTRY, get_signal  # noqa: F401
