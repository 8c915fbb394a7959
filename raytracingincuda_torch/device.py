"""The port's device rule: data goes on the card unless the caller asks
for the CPU.

``None`` means ``'cuda'``. A CUDA device asked for where
``torch.cuda.is_available()`` is False raises and names ``device='cpu'``:
nothing falls back to the CPU, and no environment variable picks the
device. The scene factories and carry-over functions (``models/``), the
renderers' scene check (``render_api``) and the examples resolve their
device here, and ``parallel/mesh.rank_device`` resolves a rank's device
here before it picks the rank's card.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is ``'cuda'``. Raises where
    a CUDA device is asked for and there is no CUDA."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for but "
                           "torch.cuda.is_available() is False, so there is "
                           "no CUDA device here: pass device='cpu' to run "
                           "on the CPU")
    return device
