"""Structure-of-arrays 3-vectors, frozen with the estimator's association.

``v / t`` multiplies by ``1.0 / t``; ``unit`` scales by ``rsqrt(max(|v|^2,
eps))``; ``lerp`` is ``a * (1 - t) + b * t``; bounds are ``torch.minimum``
/ ``torch.maximum`` with 0-d bounds, which split the gradient at a tie.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import sampler


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __truediv__(self, t):
        inv = 1.0 / t
        return Vec3(self.x * inv, self.y * inv, self.z * inv)

    def map(self, fn):
        return Vec3(fn(self.x), fn(self.y), fn(self.z))


def full(shape, c, dtype, device) -> Vec3:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return Vec3(*(torch.full(shape, v, dtype=dtype, device=device)
                  for v in c))


def minimum(x, hi):
    return torch.minimum(x, torch.full((), hi, dtype=x.dtype, device=x.device))


def maximum(x, lo):
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))


def clip(x, lo, hi):
    return minimum(maximum(x, lo), hi)


def dot(u: Vec3, v: Vec3):
    return u.x * v.x + u.y * v.y + u.z * v.z


def cross(u: Vec3, v: Vec3) -> Vec3:
    return Vec3(u.y * v.z - u.z * v.y, u.z * v.x - u.x * v.z,
                u.x * v.y - u.y * v.x)


def unit(v: Vec3, eps: float = 1e-30) -> Vec3:
    return v * sampler.rsqrt(maximum(dot(v, v), eps))


def near_zero(v: Vec3, eps: float = 1e-6):
    return (v.x.abs() < eps) & (v.y.abs() < eps) & (v.z.abs() < eps)


def reflect(v: Vec3, n: Vec3) -> Vec3:
    return v - n * (2.0 * dot(v, n))


def refract(uv: Vec3, n: Vec3, eta) -> Vec3:
    cos_theta = minimum(dot(-uv, n), 1.0)
    perp = (uv + n * cos_theta) * eta
    par = sampler.sqrt(maximum((1.0 - dot(perp, perp)).abs(), 1e-12))
    return perp + n * (-par)


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))
