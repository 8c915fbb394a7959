"""f32 sqrt, rsqrt, sin and cos that give the same bits on every device.

The port is held to the JAX package's goldens, which XLA rendered on a
CPU, and its CUDA kernel is held to its plain PyTorch version on the
card. Float math libraries disagree in the last bit: measured on 10^6
f32 inputs, PyTorch's CPU ``sin``/``cos`` differ from XLA's on about 5%
of results, its ``sqrt`` on 0.6%, and one flipped bit can send a path
another way. So the port computes these four itself:

  * ``sqrt``: f64 sqrt rounded to f32, which is the correctly rounded
    f32 sqrt (what XLA's CPU and CUDA's ``sqrtf`` give);
  * ``rsqrt``: ``1 / sqrt`` in f64, rounded to f32 (correctly rounded
    but for rare double roundings; XLA's CPU ``rsqrt`` is an
    approximation that agrees on about 88% of inputs, a tolerance);
  * ``sin``/``cos``: the algorithm of glibc's ``sinf``/``cosf`` (ARM's
    optimized-routines ``sincosf``, whose results XLA's CPU ``sin``/``cos``
    give): reduction by pi/2 and a short polynomial, all in f64, rounded
    to f32. It equals glibc bit for bit on 10^6 inputs in [0, 2 pi), the
    samplers' range; like glibc's fast path it is valid for |x| < 120.

Each is a fixed sequence of IEEE f64 operations, so CPU and GPU, and the
CUDA kernel (``csrc/regen_render.cu``, which repeats them), agree exactly.
"""
from __future__ import annotations

import torch

_F64 = torch.float64

# glibc sincosf_data.c (the build without TOINT_INTRINSICS)
HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")   # 2/pi * 2^24
HPI = float.fromhex("0x1.921FB54442D18p0")         # pi/2
C0, C1, C2, C3, C4 = (
    1.0,
    float.fromhex("-0x1.ffffffd0c621cp-2"),
    float.fromhex("0x1.55553e1068f19p-5"),
    float.fromhex("-0x1.6c087e89a359dp-10"),
    float.fromhex("0x1.99343027bf8c3p-16"),
)
S1, S2, S3 = (
    float.fromhex("-0x1.555545995a603p-3"),
    float.fromhex("0x1.1107605230bc4p-7"),
    float.fromhex("-0x1.994eb3774cf24p-13"),
)
_TOP12_PIO4 = 0x3F490FDB >> 20     # |x| below 0.75 skips the reduction
_TINY = 0x39800000                  # 0x1p-12f


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.to(_F64)).to(torch.float32)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    return (1.0 / torch.sqrt(x.to(_F64))).to(torch.float32)


def _poly(x, x2, odd, neg_cos):
    """glibc ``sinf_poly``: the sine polynomial for even quadrants, the
    (possibly negated) cosine polynomial for odd ones."""
    x3 = x * x2
    s1 = S2 + x2 * S3
    x7 = x3 * x2
    sin_v = (x + x3 * S1) + x7 * s1

    cs = torch.where(neg_cos, -1.0, 1.0).to(_F64)
    x4 = x2 * x2
    c2 = cs * C3 + x2 * (cs * C4)
    c1 = cs * C0 + x2 * (cs * C1)
    x6 = x4 * x2
    cos_v = (c1 + x4 * (cs * C2)) + x6 * c2
    return torch.where(odd, cos_v, sin_v)


def _sincos(y: torch.Tensor, cos: bool) -> torch.Tensor:
    if y.dtype != torch.float32:
        raise TypeError(f"f32 input expected, got {y.dtype}")
    x = y.to(_F64)
    bits = y.view(torch.int32) & 0x7FFFFFFF
    # |x| < 0.75 (by the top 12 bits): the polynomial directly
    no = torch.zeros_like(bits, dtype=torch.bool)
    direct = _poly(x, x * x, torch.full_like(no, cos), no)
    # else: x - n*pi/2, n rounded from x*2/pi by the 2^24 shift trick
    n = ((x * HPI_INV).to(torch.int32) + 0x800000) >> 24
    r = x - n.to(_F64) * HPI
    sign = torch.where((n + 1) & 2 != 0, -1.0, 1.0).to(_F64)  # 1,-1,-1,1
    quad = (n ^ 1) if cos else n
    reduced = _poly(r * sign, r * r, (quad & 1) != 0, (n & 2) != 0)
    out = torch.where((bits >> 20) < _TOP12_PIO4, direct, reduced)
    out = out.to(torch.float32)
    tiny = torch.ones_like(y) if cos else y
    return torch.where(bits < _TINY, tiny, out)


def sin(x: torch.Tensor) -> torch.Tensor:
    return _sincos(x, cos=False)


def cos(x: torch.Tensor) -> torch.Tensor:
    return _sincos(x, cos=True)
