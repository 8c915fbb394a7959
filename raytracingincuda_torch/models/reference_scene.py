"""The reference serial baseline's scene 1, replayed exactly.

The counterpart of ``raytracingincuda_tpu/models/reference_scene.py``.
The reference's host RNG is never seeded, so ``std::rand()`` (glibc,
default seed 1) makes the serial baseline's cover scene
(``InOneWeekend/main.cc:24-66``) a fixed piece of geometry. This module
replays its construction, the same rand() stream in the same call order,
so that the port can render the very scene the reference binary renders.

Two behaviours of that build carry the result:

  * glibc ``rand()`` is the TYPE_3 additive-feedback generator: a 31-word
    LCG-seeded state, r[i] = (r[i-31] + r[i-3]) mod 2^32, output >> 1,
    the first 310 outputs discarded;
  * g++ evaluates constructor and function arguments right to left, and
    the operands of a binary ``*`` too, so ``point3(a + 0.9*rand(), 0.2,
    b + 0.9*rand())`` draws the z jitter before the x jitter, and
    ``color::random() * color::random()`` builds the right factor first
    (each as z, y, x).

The serial scene is a dense list: spheres that fail the (4, 0.2, 0)
distance filter are absent (487 spheres: the ground, 483 small and 3
big), not inactive slots. ``SERIAL_SCENE1_SHA256`` pins the arrays.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from .scene import DIELECTRIC, LAMBERTIAN, METAL, Scene

# sha256 over the six float64 arrays of serial_scene1_arrays, in order
SERIAL_SCENE1_SHA256 = (
    "aca58f22a147bd5a5c86f8d347b33f22026bd110e6ba19a99e47d5b83016a0f8")


def _glibc_rand(seed: int = 1) -> Iterator[int]:
    """glibc ``rand()`` outputs (TYPE_3 additive feedback, the default)."""
    r = [0] * 344
    r[0] = seed
    for i in range(1, 31):
        # Schrage's split of 16807 * r mod (2^31 - 1), signed-wrap safe
        hi, lo = divmod(r[i - 1], 127773)
        v = 16807 * lo - 2836 * hi
        if v < 0:
            v += 2147483647
        r[i] = v
    for i in range(31, 34):
        r[i] = r[i - 31]
    for i in range(34, 344):
        r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
    i = 344
    while True:
        val = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        r.append(val)
        yield val >> 1
        i += 1


RAND_MAX_PLUS_1 = 2147483648.0   # RAND_MAX + 1.0 (rtweekend.h)


def serial_scene1_arrays():
    """(center (N, 3), radius, mat_type, albedo, fuzz, ior) float64 host
    arrays of the serial baseline's scene (mat_type int32), in its list
    order."""
    g = _glibc_rand()

    def rd():
        return next(g) / RAND_MAX_PLUS_1

    def rd_range(lo, hi):
        return lo + (hi - lo) * rd()

    def vec_random(lo=0.0, hi=1.0):
        # vec3(rand, rand, rand): arguments evaluated right to left
        z = rd_range(lo, hi)
        y = rd_range(lo, hi)
        x = rd_range(lo, hi)
        return np.array([x, y, z])

    rows = []   # (center, radius, mat, albedo, fuzz, ior)
    rows.append((np.array([0.0, -1000.0, 0.0]), 1000.0, LAMBERTIAN,
                 np.array([0.5, 0.5, 0.5]), 0.0, 1.0))
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rd()
            cz = b + 0.9 * rd()    # right to left: z first
            cx = a + 0.9 * rd()
            center = np.array([cx, 0.2, cz])
            if np.sqrt(((center - (4.0, 0.2, 0.0)) ** 2).sum()) <= 0.9:
                continue
            if choose_mat < 0.8:
                # color::random() * color::random(): the right operand first
                rhs = vec_random()
                lhs = vec_random()
                rows.append((center, 0.2, LAMBERTIAN, lhs * rhs, 0.0, 1.0))
            elif choose_mat < 0.95:
                albedo = vec_random(0.5, 1.0)
                fuzz = rd_range(0.0, 0.5)
                rows.append((center, 0.2, METAL, albedo, fuzz, 1.0))
            else:
                rows.append((center, 0.2, DIELECTRIC, np.zeros(3), 0.0,
                             1.5))
    rows.append((np.array([0.0, 1.0, 0.0]), 1.0, DIELECTRIC, np.zeros(3),
                 0.0, 1.5))
    rows.append((np.array([-4.0, 1.0, 0.0]), 1.0, LAMBERTIAN,
                 np.array([0.4, 0.2, 0.1]), 0.0, 1.0))
    rows.append((np.array([4.0, 1.0, 0.0]), 1.0, METAL,
                 np.array([0.7, 0.6, 0.5]), 0.0, 1.0))

    center = np.stack([r[0] for r in rows])
    radius = np.array([r[1] for r in rows])
    mat = np.array([r[2] for r in rows], np.int32)
    albedo = np.stack([r[3] for r in rows])
    fuzz = np.array([r[4] for r in rows])
    ior = np.array([r[5] for r in rows])
    return center, radius, mat, albedo, fuzz, ior


def build_serial_reference_scene(dtype=torch.float32,
                                 pad_to_multiple: Optional[int] = 128,
                                 device=None) -> Scene:
    """The serial baseline's scene as a padded Scene on ``device`` (None:
    the card; 487 spheres in 512 slots by default)."""
    from .io import scene_from_arrays

    center, radius, mat, albedo, fuzz, ior = serial_scene1_arrays()
    return scene_from_arrays(center, radius, mat, albedo=albedo, fuzz=fuzz,
                             ior=ior, dtype=dtype,
                             pad_to_multiple=pad_to_multiple, device=device)
