"""Batched ray-sphere closest hit over a (spheres, rays) broadcast.

The half-b quadratic with the JAX package's association, term for term
(``raytracingincuda_tpu/ops/pallas_kernel.py:_hit_select``):

  c2r2 = cx*cx + cy*cy + cz*cz - r*r
  h    = C.D - D.O
  c    = (c2r2 + |O|^2) - 2 * C.O
  disc = h*h - a*c

The near/far root is chosen in the numerator domain against
``T_MIN * a``, the minimum is taken over numerators (first index wins a
tie, as ``argmin`` does), and only the winner pays ``t = t_num * (1/a)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.scene import Scene
from . import f32math, vec
from .vec import Vec3

# Sentinel "no hit" distance: finite, so dead lanes never make inf - inf.
T_MISS = 1.0e30
# The reference's shadow-acne lower bound, interval(0.001, infinity).
T_MIN = 1.0e-3


class HitResult(NamedTuple):
    hit: torch.Tensor   # (R,) bool
    t: torch.Tensor     # (R,) distance along the unnormalized ray; T_MISS
    idx: torch.Tensor   # (R,) int64 winning slot (arbitrary on a miss)


def hit_world(scene: Scene, origin: Vec3, direction: Vec3,
              t_min: float = T_MIN) -> HitResult:
    """Closest hit over all slots for a flat batch of R rays; inactive
    slots never hit."""
    p = scene.params
    cx, cy, cz = p.center.x[:, None], p.center.y[:, None], p.center.z[:, None]
    rc = p.radius[:, None]
    active = scene.active[:, None]

    ox, oy, oz = origin.x[None, :], origin.y[None, :], origin.z[None, :]
    dx, dy, dz = direction.x[None, :], direction.y[None, :], direction.z[None, :]

    a = vec.maximum(dx * dx + dy * dy + dz * dz, 1e-12)          # (1, R)
    c_dot_d = cx * dx + cy * dy + cz * dz                         # (N, R)
    d_dot_o = dx * ox + dy * oy + dz * oz                         # (1, R)
    h = c_dot_d - d_dot_o

    c_dot_o = cx * ox + cy * oy + cz * oz                         # (N, R)
    c2r2 = cx * cx + cy * cy + cz * cz - rc * rc                  # (N, 1)
    o2 = ox * ox + oy * oy + oz * oz                              # (1, R)
    c = (c2r2 + o2) - 2.0 * c_dot_o

    disc = h * h - a * c
    disc_pos = disc > 0.0
    sqrtd = f32math.sqrt(torch.where(disc_pos, disc, torch.ones_like(disc)))
    tmin_a = t_min * a
    near_num = h - sqrtd
    root_num = torch.where(near_num > tmin_a, near_num, h + sqrtd)
    valid = disc_pos & (root_num > tmin_a) & active

    t_num_all = torch.where(valid, root_num, torch.full_like(root_num, T_MISS))
    t_num, idx = torch.min(t_num_all, dim=0)
    hit = t_num < T_MISS
    t = torch.where(hit, t_num * (1.0 / a[0]), torch.full_like(t_num, T_MISS))
    return HitResult(hit=hit, t=t, idx=idx)


class HitParams(NamedTuple):
    center: Vec3
    radius: torch.Tensor
    albedo: Vec3
    fuzz: torch.Tensor
    ior: torch.Tensor
    mat_type: torch.Tensor


def gather_hit_params(scene: Scene, idx: torch.Tensor) -> HitParams:
    """Per-ray parameters of the winning slot."""
    p = scene.params
    return HitParams(
        center=Vec3(p.center.x[idx], p.center.y[idx], p.center.z[idx]),
        radius=p.radius[idx],
        albedo=Vec3(p.albedo.x[idx], p.albedo.y[idx], p.albedo.z[idx]),
        fuzz=p.fuzz[idx],
        ior=p.ior[idx],
        mat_type=scene.mat_type[idx],
    )
