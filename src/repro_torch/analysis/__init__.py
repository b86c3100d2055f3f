"""The port's analysis layer (port of ``repro/analysis``).

- :mod:`repro_torch.analysis.rules`: AST rules R1-R7 over
  ``src/repro_torch`` (R7 also over ``chip_smoke.py``).
- :mod:`repro_torch.analysis.kernelcheck`: K1-K5 over the registry of
  hand-written CUDA kernels (``kernels/ops.py`` ``KERNEL_REGISTRY``):
  launch resources, coverage, padding probes and cost bounds.
- :mod:`repro_torch.analysis.contracts`: dtype and plan-memo contracts
  driven through the public query entry points on a tiny index.

CLI: ``python -m repro_torch.analysis.lint``.
"""

from repro_torch.analysis.findings import (  # noqa: F401
    Finding,
    load_baseline,
    save_baseline,
    split_by_baseline,
)
