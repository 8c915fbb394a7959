"""Structure-of-arrays 3-vector math on torch tensors.

A ``Vec3`` is three tensors of one shape, one per component, as in the
JAX package (``raytracingincuda_tpu/ops/vec.py``). Every expression keeps
that module's float association, because the CUDA kernel and the plain
PyTorch version are held to each other bit for bit on the card:

  * ``v / t`` multiplies by the reciprocal ``1.0 / t``;
  * ``unit`` scales by ``rsqrt(max(|v|^2, eps))``, with the device-exact
    ``f32math.rsqrt``;
  * ``lerp`` is ``a * (1 - t) + b * t``;
  * bounds go through ``minimum``/``maximum``/``clip`` with 0-d tensor
    bounds, never ``torch.clamp``: at a tie ``torch.clamp`` passes the
    whole gradient, while JAX's ``jnp.minimum``/``jnp.maximum``/``jnp.clip``
    pass half, and gradients are held to JAX's.

Reference parity map (the CUDA book code's ``vec3.h``): operators
:18-91, dot/cross :93-103, unit_vector :105-107, length/length_squared
:40-46, near_zero :48-52, reflect :129-131, refract :133-138.

``Vec3.full``, ``Vec3.zeros`` and ``Vec3.of`` take the ``device`` of the
data they join; every caller in the package passes it.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from . import f32math

Scalar = Union[float, torch.Tensor]


class Vec3(NamedTuple):
    """SoA 3-vector: three tensors of identical shape."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, o: Union["Vec3", Scalar]) -> "Vec3":
        if isinstance(o, Vec3):  # componentwise
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o: Scalar) -> "Vec3":
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __truediv__(self, t: Scalar) -> "Vec3":
        inv = 1.0 / t
        return Vec3(self.x * inv, self.y * inv, self.z * inv)

    @property
    def shape(self):
        return self.x.shape

    @property
    def dtype(self):
        return self.x.dtype

    def astype(self, dtype) -> "Vec3":
        return Vec3(self.x.to(dtype), self.y.to(dtype), self.z.to(dtype))

    def reshape(self, *shape) -> "Vec3":
        return Vec3(self.x.reshape(*shape), self.y.reshape(*shape),
                    self.z.reshape(*shape))

    def stack(self, dim: int = -1) -> torch.Tensor:
        """A dense (..., 3) tensor (``dim`` is JAX's ``axis``)."""
        return torch.stack([self.x, self.y, self.z], dim=dim)

    @staticmethod
    def from_stacked(a: torch.Tensor, dim: int = -1) -> "Vec3":
        """Inverse of ``stack``: the three slices of ``a`` along ``dim``."""
        return Vec3(*torch.unbind(a, dim))

    @staticmethod
    def full(shape, cx, cy, cz, dtype=torch.float32, device="cpu") -> "Vec3":
        return Vec3(
            torch.full(shape, cx, dtype=dtype, device=device),
            torch.full(shape, cy, dtype=dtype, device=device),
            torch.full(shape, cz, dtype=dtype, device=device),
        )

    @staticmethod
    def zeros(shape, dtype=torch.float32, device="cpu") -> "Vec3":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return Vec3(z, z, z)

    @staticmethod
    def of(cx, cy, cz, dtype=torch.float32, device="cpu") -> "Vec3":
        """A Vec3 of 0-d tensors (camera constants and the like)."""
        return Vec3(*(torch.tensor(c, dtype=dtype, device=device)
                      for c in (cx, cy, cz)))


def _bound(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full((), v, dtype=x.dtype, device=x.device)


def minimum(x: torch.Tensor, hi: float) -> torch.Tensor:
    """``jnp.minimum(x, hi)``: half the gradient to ``x`` at a tie."""
    return torch.minimum(x, _bound(x, hi))


def maximum(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``: half the gradient to ``x`` at a tie."""
    return torch.maximum(x, _bound(x, lo))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` = ``minimum(maximum(x, lo), hi)``."""
    return minimum(maximum(x, lo), hi)


def dot(u: Vec3, v: Vec3) -> torch.Tensor:
    return u.x * v.x + u.y * v.y + u.z * v.z


def length_sq(v: Vec3) -> torch.Tensor:
    return dot(v, v)


def length(v: Vec3) -> torch.Tensor:
    return torch.sqrt(length_sq(v))


def cross(u: Vec3, v: Vec3) -> Vec3:
    return Vec3(
        u.y * v.z - u.z * v.y,
        u.z * v.x - u.x * v.z,
        u.x * v.y - u.y * v.x,
    )


def unit(v: Vec3, eps: float = 1e-30) -> Vec3:
    """Normalize; a zero vector stays finite (returns ~0, not NaN)."""
    inv = f32math.rsqrt(maximum(length_sq(v), eps))
    return v * inv


def near_zero(v: Vec3, eps: float = 1e-6) -> torch.Tensor:
    """Componentwise |v| < eps (the degenerate-scatter guard)."""
    return (v.x.abs() < eps) & (v.y.abs() < eps) & (v.z.abs() < eps)


def reflect(v: Vec3, n: Vec3) -> Vec3:
    return v - n * (2.0 * dot(v, n))


def refract(uv: Vec3, n: Vec3, etai_over_etat: torch.Tensor) -> Vec3:
    """Snell refraction of unit vector uv about unit normal n."""
    cos_theta = minimum(dot(-uv, n), 1.0)
    r_out_perp = (uv + n * cos_theta) * etai_over_etat
    par_len = f32math.sqrt(
        maximum((1.0 - length_sq(r_out_perp)).abs(), 1e-12)
    )
    r_out_parallel = n * (-par_len)
    return r_out_perp + r_out_parallel


def where(mask: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    """Lane-masked select."""
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def lerp(t: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    """(1-t)*a + t*b, the sky gradient blend."""
    return a * (1.0 - t) + b * t


def safe_radius(r: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """SIGNED radius guarded away from zero: a negative radius flips the
    normal inward (the hollow-glass trick) while a gathered radius of 0
    on a miss lane stays finite."""
    return torch.where(r.abs() > eps, r, torch.full_like(r, eps))
