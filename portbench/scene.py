"""The configuration's scene as the run's tensors on the device.

The layout is drawn on the host by ``reference/scenes.py`` from the
configuration's own seed: the source's scene, which the render cells
render. Fit i starts from it with each albedo channel scaled by 1 + j (2u
- 1), u drawn on the device by a ``torch.Generator`` seeded with the
configuration's jitter seed plus i, so every run has the same scenes and
the same work (under Russian roulette an albedo sets how long paths run).
The run's ``--seed`` draws what its check reads (``generator``). The port
and the reference are handed the same tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import scenes, tracer


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def make(config: dict, device) -> dict:
    """The slot tensors (``tracer.LEAVES``, ``mat``, ``active``) of the
    scene as drawn, on ``device``."""
    spec = config["scene"]
    arrays = scenes.BUILDERS[spec["builder"]](**spec["args"])
    out = {k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(
        device=device, dtype=torch.float32) for k in tracer.LEAVES}
    out["mat"] = torch.from_numpy(arrays["mat"].astype(np.int32)).to(device)
    out["active"] = torch.from_numpy(arrays["active"]).to(device)
    return out


def start(config: dict, scene: dict, fit: int) -> dict:
    """Fit ``fit``'s start: ``scene`` with each albedo channel scaled by 1
    + j (2u - 1), clipped to [0, 1], u drawn on the device from the
    configuration's jitter seed plus ``fit``."""
    spec = config["scene"]["jitter"]
    u = torch.rand((3, scene["ar"].shape[0]),
                   generator=generator(spec["seed"] + fit, scene["ar"].device),
                   device=scene["ar"].device)
    out = dict(scene)
    for row, k in zip(u, ("ar", "ag", "ab")):
        out[k] = torch.clamp(
            scene[k] * (1.0 + spec["amount"] * (2.0 * row - 1.0)), 0.0, 1.0)
    return out
