"""The needed work of a render and the least time the card could take.

The count is what any implementation of the same estimator must do,
whatever schedules its scan; the scan over candidate spheres is not
counted, so a cheaper scan raises the share and no scan can push it past
100%. It is taken per traced segment (one bounce of one sample) from the
frozen reference (``reference/sampler.py``, ``reference/tracer.py``):

- every Threefry-2x32 block the estimator draws: two a sample (the
  jitter and the defocus disk), one a segment that ends at a sphere (the
  scatter's unit vector, or a glass sphere's coin), one a Russian-roulette
  coin inside the roulette zone. A block is ``threefry_ops()`` integer
  operations (112: two key adds, 20 rounds of add, rotate (two shifts and
  an or) and xor, five key injections of two adds);
- one ray-sphere test at the hit, 18 f32 operations (``TEST_OPS``: |C|^2
  - r^2 belongs to the scene, as the kernel tables count it);
- the shading at a hit: the distance, the hit point, the normal, the
  facing test and the attenuation (``SHADE_OPS``) and the cheapest
  material's scatter, the diffuse one (``SCATTER_OPS``);
- at a miss, the sky and its weighted add (``SKY_OPS``);
- a sample's camera ray with its jitter and defocus point
  (``CAMERA_OPS``); a roulette draw's survival test and reweight
  (``RR_OPS``).

f32 operations that a sin, cos or sqrt costs are counted as one each, and
the float operations of the uniforms' mantissa fill are left out, so
every term is a floor. Bytes: the scene read once and the image written
once. The least time is the largest of the f32 operations over 67 TFLOP/s,
the integer operations over 33.5 TOP/s and the bytes over 3.35 TB/s,
NVIDIA's H100 SXM figures at 700 W (Hopper issues 64 INT32 lanes an SM
against 128 FP32 lanes).
"""
from __future__ import annotations

from .reference import sampler

FP32_PER_S = 67e12
INT32_PER_S = 33.5e12
BYTES_PER_S = 3.35e12

TEST_OPS = 18
# t = root * (1/a) 2; p = o + d t 6; (p - c) * (1/r) 7; facing dot and
# compare 6; attenuation 3
SHADE_OPS = 24
# unit vector 10 (1 - 2u, 1 - z^2, sqrt, 2 pi u, cos, sin, r cos, r sin);
# normal + u 3; the near-zero guard 6
SCATTER_OPS = 19
# unit(d) 9; 0.5 (y + 1) 2; the blend 10; atten * sky 3; the add 3
SKY_OPS = 27
# jitter offsets 4; the pixel point 12; the disk point 6; the lens point
# 12; the direction 3
CAMERA_OPS = 37
# clip of the largest channel 4; the compare 1; 1 / p 1; the reweight 3
RR_OPS = 9
# a pixel's 1/spp and gamma: 3 multiplies and 3 square roots
FINISH_OPS = 6
COUNT_KEYS = ("samples", "hits", "misses", "rr_draws")


class _Count:
    """An integer that counts the operations done on it (the masks that
    emulate 32-bit words in int64 are free)."""
    n = 0

    def __init__(self, v: int = 0):
        self.v = v

    def _op(self, other, fn):
        _Count.n += 1
        o = other.v if isinstance(other, _Count) else other
        return _Count(fn(self.v, o))

    __add__ = lambda s, o: s._op(o, lambda a, b: a + b)  # noqa: E731
    __xor__ = lambda s, o: s._op(o, lambda a, b: a ^ b)  # noqa: E731
    __or__ = lambda s, o: s._op(o, lambda a, b: a | b)  # noqa: E731
    __lshift__ = lambda s, o: s._op(o, lambda a, b: a << b)  # noqa: E731
    __rshift__ = lambda s, o: s._op(o, lambda a, b: a >> b)  # noqa: E731

    def __and__(self, o):
        return _Count(self.v & (o.v if isinstance(o, _Count) else o))


def threefry_ops() -> int:
    """Integer operations of one Threefry-2x32 block, counted by running
    the frozen sampler on counting words."""
    saved = sampler._u32
    sampler._u32 = lambda x: x if isinstance(x, _Count) else _Count(int(x))
    try:
        _Count.n = 0
        sampler.threefry2x32(1, 2, _Count(3), _Count(4))
        return _Count.n
    finally:
        sampler._u32 = saved


def needed(counts: dict, pixels: int, slots: int) -> dict:
    """Operations and bytes of a render from its segment counts
    (``COUNT_KEYS``, already scaled to the whole image)."""
    block = threefry_ops()
    fp = (counts["samples"] * CAMERA_OPS
          + counts["hits"] * (TEST_OPS + SHADE_OPS + SCATTER_OPS)
          + counts["misses"] * SKY_OPS + counts["rr_draws"] * RR_OPS
          + pixels * FINISH_OPS)
    ints = block * (2 * counts["samples"] + counts["hits"]
                    + counts["rr_draws"])
    nbytes = slots * 11 * 4 + pixels * 3 * 4
    return {"fp32_ops": float(fp), "int32_ops": float(ints),
            "bytes": float(nbytes)}


def least_seconds(work: dict) -> float:
    return max(work["fp32_ops"] / FP32_PER_S, work["int32_ops"] / INT32_PER_S,
               work["bytes"] / BYTES_PER_S)


def scale(counts: dict, factor: float) -> dict:
    return {k: counts[k] * factor for k in COUNT_KEYS}
