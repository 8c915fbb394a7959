"""The system under test: the port's public entry points, as its users
call them. The one module of the harness, with the entries, that imports
the port (``raytracingincuda_torch``); the reference imports none of it.
"""
from __future__ import annotations

from pathlib import Path

import torch

import raytracingincuda_torch
from raytracingincuda_torch.config import RenderConfig
from raytracingincuda_torch.models.camera import CameraConfig
from raytracingincuda_torch.models.scene import Scene, params_from_leaves
from raytracingincuda_torch.ops import grad, render_kernel, stream_kernel
from raytracingincuda_torch.ops.vec import Vec3
from raytracingincuda_torch.render_api import make_renderer

from .reference.tracer import LEAVES

PACKAGE_DIR = Path(raytracingincuda_torch.__file__).resolve().parent

__all__ = ["PACKAGE_DIR", "RenderConfig", "grad", "make_renderer",
           "render_kernel", "stream_kernel"]


def scene(t: dict) -> Scene:
    """The port's Scene over the run's slot tensors."""
    return Scene(params_from_leaves([t[k] for k in LEAVES]), t["mat"],
                 t["active"])


def camera(cam: dict) -> CameraConfig:
    """The camera as the port takes it: host float32 scalars."""
    def s(v):
        return torch.tensor(float(v), dtype=torch.float32)

    def v3(c):
        return Vec3(*(s(x) for x in c))

    return CameraConfig(vfov=s(cam["vfov"]), lookfrom=v3(cam["lookfrom"]),
                        lookat=v3(cam["lookat"]), vup=v3(cam["vup"]),
                        defocus_angle=s(cam["defocus_angle"]),
                        focus_dist=s(cam["focus_dist"]))


def trainable(names) -> "SceneParams":
    """The leaves named in ``names`` (of ``LEAVES``) as the train steps'
    ``trainable`` mask."""
    return params_from_leaves([k in names for k in LEAVES])


def leaves(params) -> list:
    """A state's nine parameter tensors, in ``LEAVES`` order."""
    return [*params.center, params.radius, *params.albedo, params.fuzz,
            params.ior]
