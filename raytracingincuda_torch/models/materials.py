"""Material scatter: lambertian / metal / dielectric, lane-selected.

All three candidates are computed for every lane from one unit-vector
draw and one coin draw, then selected by material id, exactly as in
``raytracingincuda_tpu/models/materials.py``. The CUDA kernel computes
only the winning branch; each branch's arithmetic is the same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import f32math, vec
from ..ops.vec import Vec3
from .scene import DIELECTRIC, LAMBERTIAN, METAL


class ScatterResult(NamedTuple):
    direction: Vec3
    attenuation: Vec3
    scattered: torch.Tensor  # bool: False => absorbed (metal below surface)


def pow5(x: torch.Tensor) -> torch.Tensor:
    """x**5 as JAX lowers ``x ** 5`` (``lax.integer_pow``, square and
    multiply): x * ((x*x) * (x*x))."""
    x2 = x * x
    return x * (x2 * x2)


def schlick_reflectance(cosine: torch.Tensor, ri: torch.Tensor) -> torch.Tensor:
    """Schlick's approximation."""
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    one_minus = 1.0 - cosine
    return r0 + (1.0 - r0) * pow5(one_minus)


def scatter(
    d_in: Vec3,
    normal: Vec3,
    front_face: torch.Tensor,
    mat_type: torch.Tensor,
    albedo: Vec3,
    fuzz: torch.Tensor,
    ior: torch.Tensor,
    unit_rand: Vec3,
    coin_u: torch.Tensor,
) -> ScatterResult:
    """Evaluate every material and select by ``mat_type``."""
    one = torch.ones_like(fuzz)

    lam_dir = normal + unit_rand
    lam_dir = vec.where(vec.near_zero(lam_dir), normal, lam_dir)

    reflected = vec.unit(vec.reflect(d_in, normal))
    metal_dir = reflected + unit_rand * fuzz
    metal_ok = vec.dot(metal_dir, normal) > 0.0

    ri = torch.where(front_face, 1.0 / ior, ior)
    ud = vec.unit(d_in)
    cos_theta = vec.minimum(vec.dot(-ud, normal), 1.0)
    sin_theta = f32math.sqrt(vec.maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ri * sin_theta > 1.0
    reflect_coin = schlick_reflectance(cos_theta, ri) > coin_u
    diel_dir = vec.where(
        cannot_refract | reflect_coin,
        vec.reflect(ud, normal),
        vec.refract(ud, normal, ri),
    )

    is_lam = mat_type == LAMBERTIAN
    is_metal = mat_type == METAL
    is_diel = mat_type == DIELECTRIC

    direction = vec.where(is_lam, lam_dir,
                          vec.where(is_metal, metal_dir, diel_dir))
    attenuation = vec.where(is_diel, Vec3(one, one, one), albedo)
    scattered = metal_ok | ~is_metal
    return ScatterResult(direction, attenuation, scattered)
