"""Positionable defocus-blur camera (f32).

``CameraConfig`` holds the user's parameters (the reference's hard-coded
values by default) and ``initialize`` derives the frame with the JAX
package's viewport math (``raytracingincuda_tpu/models/camera.py``),
term for term. The camera is host data: it is derived once per render
and packed into a 24-float row for the kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import vec
from ..ops.vec import Vec3


class CameraConfig(NamedTuple):
    vfov: torch.Tensor            # vertical field of view, degrees
    lookfrom: Vec3
    lookat: Vec3
    vup: Vec3
    defocus_angle: torch.Tensor   # degrees; <= 0 disables defocus blur
    focus_dist: torch.Tensor

    @staticmethod
    def reference_default(dtype=torch.float32, device="cpu") -> "CameraConfig":
        def s(v):
            return torch.tensor(v, dtype=dtype, device=device)

        return CameraConfig(
            vfov=s(20.0),
            lookfrom=Vec3(s(13.0), s(2.0), s(3.0)),
            lookat=Vec3(s(0.0), s(0.0), s(0.0)),
            vup=Vec3(s(0.0), s(1.0), s(0.0)),
            defocus_angle=s(0.6),
            focus_dist=s(10.0),
        )


def config_leaves(cfg: CameraConfig) -> list:
    """The 12 scalars of a CameraConfig in the JAX pytree's leaf order:
    vfov, lookfrom x/y/z, lookat x/y/z, vup x/y/z, defocus_angle,
    focus_dist."""
    return [cfg.vfov, *cfg.lookfrom, *cfg.lookat, *cfg.vup,
            cfg.defocus_angle, cfg.focus_dist]


def config_from_leaves(leaves) -> CameraConfig:
    """Inverse of ``config_leaves``."""
    t = list(leaves)
    return CameraConfig(t[0], Vec3(*t[1:4]), Vec3(*t[4:7]), Vec3(*t[7:10]),
                        t[10], t[11])


class Camera(NamedTuple):
    center: Vec3
    pixel00_loc: Vec3
    pixel_delta_u: Vec3
    pixel_delta_v: Vec3
    defocus_disk_u: Vec3
    defocus_disk_v: Vec3
    use_defocus: torch.Tensor     # bool scalar: defocus_angle > 0


def initialize(cfg: CameraConfig, img_width: int, img_height: int) -> Camera:
    """The reference's viewport math, in the config's dtype."""
    theta = cfg.vfov * (math.pi / 180.0)
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h * cfg.focus_dist
    viewport_width = viewport_height * (float(img_width) / float(img_height))

    w = vec.unit(cfg.lookfrom - cfg.lookat)
    u = vec.unit(vec.cross(cfg.vup, w))
    v = vec.cross(w, u)

    viewport_u = u * viewport_width
    viewport_v = (-v) * viewport_height

    pixel_delta_u = viewport_u / float(img_width)
    pixel_delta_v = viewport_v / float(img_height)

    center = cfg.lookfrom
    viewport_upper_left = (
        center - w * cfg.focus_dist - viewport_u / 2.0 - viewport_v / 2.0
    )
    pixel00_loc = viewport_upper_left + (pixel_delta_u + pixel_delta_v) * 0.5

    defocus_radius = cfg.focus_dist * torch.tan(
        (cfg.defocus_angle / 2.0) * (math.pi / 180.0)
    )
    return Camera(
        center=center,
        pixel00_loc=pixel00_loc,
        pixel_delta_u=pixel_delta_u,
        pixel_delta_v=pixel_delta_v,
        defocus_disk_u=u * defocus_radius,
        defocus_disk_v=v * defocus_radius,
        use_defocus=cfg.defocus_angle > 0.0,
    )
