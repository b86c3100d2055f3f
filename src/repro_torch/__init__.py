"""PyTorch and CUDA port of the RANGE-LSH system in ``repro``.

The package runs on a CUDA device unless the caller passes
``device="cpu"``; an entry point asked for no device on a host without
one raises instead of carrying on on the CPU. It imports neither JAX nor
the ``repro`` package.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless ``device`` says
    otherwise; ``RuntimeError`` when no card is present and none was
    named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card; pass "
                "device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)
