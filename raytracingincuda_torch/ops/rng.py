"""Counter-based Threefry-2x32 random stream, bit-equal to the JAX package.

Every draw is a pure function of (seed, pixel, sample, bounce, draw)
(``raytracingincuda_tpu/ops/rng.py``): no generator state, so renders are
bit-identical under any chunking, ordering or regeneration of rays, and
the CUDA kernel (``csrc/regen_render.cu``) computes the same words in
``uint32``.

Counter layout (uint32 words):
  c0 = ray id (global pixel index)
  c1 = (sample << 11) | (bounce << 3) | draw
       sample < 2^21, bounce < 256, draw < 8

PyTorch's CPU ``uint32`` tensors have no ``+``, ``<<`` or ``>>``, so the
words are computed in ``int64`` and masked to 32 bits after every step
that can carry out. Word tensors returned here are ``int64`` holding
values in [0, 2^32).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import f32math
from .vec import Vec3

DEFAULT_SEED = 1227

# Draw ids (the `draw` field of c1). Camera draws use the bounce=0 slots
# 4..7 so they never collide with the per-bounce draws 0..3.
DRAW_SCATTER = 0      # unit-vector draw shared by lambertian/metal
DRAW_COIN = 1         # dielectric reflect/refract coin
DRAW_RR = 2           # Russian-roulette survival coin
DRAW_JITTER = 4       # pixel-square antialiasing jitter (2 uniforms)
DRAW_DEFOCUS = 5      # defocus disk sample (2 uniforms)

_SAMPLE_SHIFT = 11
_BOUNCE_SHIFT = 3
_MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)

# counter field capacities: exceeding them would alias adjacent fields
MAX_SAMPLE_ID = 1 << 21
MAX_BOUNCE = 1 << (_SAMPLE_SHIFT - _BOUNCE_SHIFT)


def _u32(x):
    """A python int or int tensor masked to 32 bits (tensors as int64)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, c0, c1) -> Tuple[torch.Tensor, torch.Tensor]:
    """20-round Threefry-2x32: (key, counter) -> 2 words. Arguments
    broadcast together; key words are python ints."""
    k0, k1 = int(k0) & _MASK, int(k1) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (_u32(c0) + k0) & _MASK
    x1 = (_u32(c1) + k1) & _MASK
    for group in range(5):
        rots = _ROT_A if group % 2 == 0 else _ROT_B
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        i = group + 1
        x0 = (x0 + ks[i % 3]) & _MASK
        x1 = (x1 + ((ks[(i + 1) % 3] + i) & _MASK)) & _MASK
    return x0, x1


def key_from_seed(seed: int) -> Tuple[int, int]:
    """A 2x32 key from a python int seed (64 bits used)."""
    seed = int(seed)
    return seed & _MASK, (seed >> 32) & _MASK


def make_counter(sample, bounce, draw) -> torch.Tensor:
    """Pack (sample, bounce, draw) into the c1 counter word."""
    return ((_u32(sample) << _SAMPLE_SHIFT) | (_u32(bounce) << _BOUNCE_SHIFT)
            | _u32(draw)) & _MASK


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 word -> f32 in [0, 1) by mantissa fill: 23 random bits."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return one.view(torch.float32) - 1.0


def uniform2(key, ray_id, sample, bounce, draw):
    """Two independent f32 uniforms in [0,1) per lane for one slot."""
    b0, b1 = threefry2x32(key[0], key[1], ray_id,
                          make_counter(sample, bounce, draw))
    return _bits_to_unit_float(b0), _bits_to_unit_float(b1)


def random_unit_vector(key, ray_id, sample, bounce, draw) -> Vec3:
    """Uniform direction on S^2 by inversion (z = 1-2u, phi = 2 pi u)."""
    u0, u1 = uniform2(key, ray_id, sample, bounce, draw)
    z = 1.0 - 2.0 * u0
    r = f32math.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u1
    return Vec3(r * f32math.cos(phi), r * f32math.sin(phi), z)


def random_in_unit_disk(key, ray_id, sample):
    """Uniform point in the unit disk by inversion (r = sqrt(u))."""
    u0, u1 = uniform2(key, ray_id, sample, 0, DRAW_DEFOCUS)
    r = f32math.sqrt(u0)
    theta = (2.0 * math.pi) * u1
    return r * f32math.cos(theta), r * f32math.sin(theta)


def validate_stream_ids(max_sample_id_exclusive: int, max_depth: int) -> None:
    """Check that (sample, bounce) ids fit their counter fields."""
    if max_sample_id_exclusive > MAX_SAMPLE_ID:
        raise ValueError(
            f"sample ids up to {max_sample_id_exclusive} exceed the "
            f"counter field ({MAX_SAMPLE_ID}); streams would alias "
            "(sample_offset + samples_per_pixel must fit 21 bits)"
        )
    if max_depth > MAX_BOUNCE:
        raise ValueError(
            f"max_depth {max_depth} exceeds the bounce counter field "
            f"({MAX_BOUNCE}); bounce streams would alias the next sample"
        )


def validate_rr_start(rr_start):
    """``rr_start`` must be a non-negative integer or None; returns it as
    a python int. The later backward kernels replay the RR zone test in
    the integer domain, so a fractional start would desync them."""
    if rr_start is None:
        return None
    r = int(rr_start)
    if r != rr_start or r < 0:
        raise ValueError(
            f"rr_start must be a non-negative integer (got {rr_start!r}):"
            " the backward kernels replay the RR zone test in the integer"
            " domain and a fractional rr_start would desync the forward's"
            " float-domain test by one bounce"
        )
    return r
