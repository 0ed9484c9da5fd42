"""Signal models: descriptors + PRN code-table builders.

A *signal descriptor* captures everything the engines need to acquire and
track one GNSS signal — the reference encodes the same information across
65 near-identical scripts plus 30 signal modules (SURVEY.md §2.2-2.4).
"""

from gnss_dsp_tpu_torch.models.signal import Signal, REGISTRY, get_signal  # noqa: F401
