"""The estimator's random stream and its device-exact f32 math, frozen.

A plain copy of the port's sampler as the benchmark was defined: the
counter-based Threefry-2x32 stream, every draw a pure function of (seed,
pixel, sample, bounce, draw), and the f32 ``sqrt``, ``rsqrt``, ``sin`` and
``cos`` computed as fixed IEEE double sequences, so the card and the CPU
give the same bits. The sampler is part of the estimator's definition:
the image is fixed bit for bit by it.

Counter layout (uint32 words): c0 = pixel id; c1 = (sample << 11) |
(bounce << 3) | draw. Words are int64 tensors holding values in
[0, 2^32).

``dtype`` selects the precision of everything after the words. float32
is the estimator as defined. A lower type (the control) takes torch's own
functions in that type.
"""
from __future__ import annotations

import math

import numpy as np
import torch

DRAW_SCATTER = 0
DRAW_COIN = 1
DRAW_RR = 2
DRAW_JITTER = 4
DRAW_DEFOCUS = 5

_SAMPLE_SHIFT = 11
_BOUNCE_SHIFT = 3
_MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_F64 = torch.float64


def key_from_seed(seed: int) -> tuple:
    """A 2x32 key from a python int seed (64 bits used)."""
    seed = int(seed)
    return seed & _MASK, (seed >> 32) & _MASK


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, c0, c1):
    """20-round Threefry-2x32: (key, counter) -> 2 words."""
    k0, k1 = int(k0) & _MASK, int(k1) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (_u32(c0) + k0) & _MASK
    x1 = (_u32(c1) + k1) & _MASK
    for group in range(5):
        for r in (_ROT_A if group % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        i = group + 1
        x0 = (x0 + ks[i % 3]) & _MASK
        x1 = (x1 + ((ks[(i + 1) % 3] + i) & _MASK)) & _MASK
    return x0, x1


def counter(sample, bounce, draw):
    return ((_u32(sample) << _SAMPLE_SHIFT) | (_u32(bounce) << _BOUNCE_SHIFT)
            | _u32(draw)) & _MASK


def _unit_float(bits):
    """uint32 word -> f32 in [0, 1) by mantissa fill (23 random bits)."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return one.view(torch.float32) - 1.0


def uniform2(key, pixel, sample, bounce, draw, dtype=torch.float32):
    """Two uniforms in [0, 1) per lane: the f32 fill, then cast."""
    b0, b1 = threefry2x32(key[0], key[1], pixel, counter(sample, bounce, draw))
    return _unit_float(b0).to(dtype), _unit_float(b1).to(dtype)


# -- device-exact f32 math ---------------------------------------------------

_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
      float.fromhex("0x1.55553e1068f19p-5"),
      float.fromhex("-0x1.6c087e89a359dp-10"),
      float.fromhex("0x1.99343027bf8c3p-16"))
_S = (float.fromhex("-0x1.555545995a603p-3"),
      float.fromhex("0x1.1107605230bc4p-7"),
      float.fromhex("-0x1.994eb3774cf24p-13"))
_TOP12_PIO4 = 0x3F490FDB >> 20
_TINY = 0x39800000


def sqrt(x):
    """The correctly rounded f32 sqrt (f64 sqrt, rounded); torch's own in
    a lower type. Differentiable."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.to(_F64)).to(torch.float32)
    return torch.sqrt(x)


def rsqrt(x):
    if x.dtype == torch.float32:
        return (1.0 / torch.sqrt(x.to(_F64))).to(torch.float32)
    return torch.rsqrt(x)


def _poly(x, x2, odd, neg_cos):
    x3 = x * x2
    s1 = _S[1] + x2 * _S[2]
    x7 = x3 * x2
    sin_v = (x + x3 * _S[0]) + x7 * s1
    cs = torch.where(neg_cos, -1.0, 1.0).to(_F64)
    x4 = x2 * x2
    c2 = cs * _C[3] + x2 * (cs * _C[4])
    c1 = cs * _C[0] + x2 * (cs * _C[1])
    x6 = x4 * x2
    cos_v = (c1 + x4 * (cs * _C[2])) + x6 * c2
    return torch.where(odd, cos_v, sin_v)


def _sincos(y, cos):
    if y.dtype != torch.float32:
        return torch.cos(y) if cos else torch.sin(y)
    x = y.to(_F64)
    bits = y.view(torch.int32) & 0x7FFFFFFF
    no = torch.zeros_like(bits, dtype=torch.bool)
    direct = _poly(x, x * x, torch.full_like(no, cos), no)
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    r = x - n.to(_F64) * _HPI
    sign = torch.where((n + 1) & 2 != 0, -1.0, 1.0).to(_F64)
    quad = (n ^ 1) if cos else n
    reduced = _poly(r * sign, r * r, (quad & 1) != 0, (n & 2) != 0)
    out = torch.where((bits >> 20) < _TOP12_PIO4, direct, reduced)
    out = out.to(torch.float32)
    tiny = torch.ones_like(y) if cos else y
    return torch.where(bits < _TINY, tiny, out)


def sin(x):
    return _sincos(x, cos=False)


def cos(x):
    return _sincos(x, cos=True)


def unit_vector(key, pixel, sample, bounce, dtype=torch.float32):
    """Uniform direction on the sphere by inversion (z = 1 - 2u, phi = 2 pi
    u), from the scatter draw."""
    u0, u1 = uniform2(key, pixel, sample, bounce, DRAW_SCATTER, dtype)
    z = 1.0 - 2.0 * u0
    r = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u1
    return r * cos(phi), r * sin(phi), z


def in_unit_disk(key, pixel, sample, dtype=torch.float32):
    """Uniform point in the unit disk by inversion (r = sqrt(u))."""
    u0, u1 = uniform2(key, pixel, sample, 0, DRAW_DEFOCUS, dtype)
    r = sqrt(u0)
    theta = (2.0 * math.pi) * u1
    return r * cos(theta), r * sin(theta)


def f32(x: float) -> float:
    """A python float rounded to f32."""
    return float(np.float32(x))
