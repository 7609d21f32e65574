"""PyTorch / CUDA port of the MR-HRC CORDIC system (``repro``), for one
NVIDIA H100.

Layout mirrors ``src/repro/`` file for file; each module names the JAX
module it ports. The package imports ``torch`` only. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Raises when CUDA is wanted but absent, so a run on a
    machine without a card never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
