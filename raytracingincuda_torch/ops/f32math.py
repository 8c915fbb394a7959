"""sqrt, rsqrt, sin and cos that give the same bits on every device.

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

Each of the four follows its input's dtype. For float64 input (the f64
oracle, ``tracer.render(dtype=torch.float64)``, the counterpart of the
JAX package's native-f64 oracle):

  * ``sqrt`` is the correctly rounded double sqrt: numpy's on the CPU,
    where torch's vectorized float64 ``sqrt`` is an ulp off on about
    0.75% of inputs, and torch's on the card, which is exact. It is
    differentiable, with JAX's derivative ``g * (0.5 / sqrt(x))``;
  * ``rsqrt`` is ``1 / sqrt``. XLA's CPU float64 ``rsqrt`` is an
    estimate refined by Newton steps, within 2 ulp of it (equal on 75% of
    10^6 inputs in [0, 4));
  * ``sin``/``cos`` are numpy's on the CPU, equal to glibc's and to JAX's
    float64 ``jnp.sin``/``jnp.cos`` on all of 10^6 sampler angles 2 pi u
    (torch's vectorized ones differ by an ulp on 0.19%), and torch's on
    the card. They take no gradient: the samplers' angles are random
    draws, which are constants.
"""
from __future__ import annotations

import numpy as np
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


def _host_or_card(np_fn, torch_fn, x: torch.Tensor) -> torch.Tensor:
    """A float64 op through numpy on the CPU, through torch on the card."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np_fn(x.detach().numpy())))
    return torch_fn(x)


class _Sqrt64(torch.autograd.Function):
    """The correctly rounded float64 sqrt, with JAX's derivative."""

    @staticmethod
    def forward(ctx, x):
        out = _host_or_card(np.sqrt, torch.sqrt, x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * (0.5 / out)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == _F64:
        return _Sqrt64.apply(x)
    return torch.sqrt(x.to(_F64)).to(torch.float32)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == _F64:
        return 1.0 / _Sqrt64.apply(x)
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
    if y.dtype == _F64:
        if y.requires_grad:
            raise ValueError("float64 sin/cos take no gradient")
        return _host_or_card(np.cos if cos else np.sin,
                             torch.cos if cos else torch.sin, y)
    if y.dtype != torch.float32:
        raise TypeError(f"f32 or f64 input expected, got {y.dtype}")
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
