"""The configurations' scenes as arrays: frozen copies of the scene builders.

``cover`` is the final scene of Ray Tracing in One Weekend as the
reference draws it (a ground sphere, a 22 x 22 grid of small spheres with
the reference's material mix and draw order, three large spheres), in
slots padded to a multiple of 128 with inactive slots far below the
world. ``random_spheres`` scatters n spheres of the same material mix
uniformly over a square ground patch. Both return float64 numpy arrays
under the leaf names of ``tracer.LEAVES`` with ``mat`` and ``active``;
the benchmark hands the same arrays to the port and to the reference.
"""
from __future__ import annotations

import numpy as np

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2


def _empty(n_slots: int) -> dict:
    center = np.zeros((n_slots, 3))
    center[:, 1] = -1.0e6
    return dict(center=center, radius=np.ones(n_slots),
                albedo=np.zeros((n_slots, 3)), fuzz=np.zeros(n_slots),
                ior=np.ones(n_slots), mat=np.zeros(n_slots, np.int32),
                active=np.zeros(n_slots, bool))


def _set(s, i, center, radius, mat, albedo=(0, 0, 0), fuzz=0.0, ior=1.0):
    s["center"][i] = center
    s["radius"][i] = radius
    s["mat"][i] = mat
    s["albedo"][i] = albedo
    s["fuzz"][i] = min(fuzz, 1.0)
    s["ior"][i] = ior
    s["active"][i] = True


def _leaves(s) -> dict:
    return dict(cx=s["center"][:, 0], cy=s["center"][:, 1],
                cz=s["center"][:, 2], radius=s["radius"],
                ar=s["albedo"][:, 0], ag=s["albedo"][:, 1],
                ab=s["albedo"][:, 2], fuzz=s["fuzz"], ior=s["ior"],
                mat=s["mat"], active=s["active"])


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def cover(seed: int = 1227, grid: int = 11, pad: int = 128) -> dict:
    """The cover scene: 1 + (2 grid)^2 + 3 slots before padding; the small
    spheres in the reference's loop order, each kept unless it lies within
    0.9 of (4, 0.2, 0)."""
    n = 1 + (2 * grid) ** 2 + 3
    s = _empty(_round_up(n, pad))
    rng = np.random.default_rng(seed)
    _set(s, 0, (0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5))
    for a in range(-grid, grid):
        for b in range(-grid, grid):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               b + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) > 0.9:
                i = (a + grid) * 2 * grid + (b + grid) + 1
                if choose < 0.8:
                    _set(s, i, center, 0.2, LAMBERTIAN,
                         rng.random(3) * rng.random(3))
                elif choose < 0.95:
                    albedo = 0.5 + 0.5 * rng.random(3)
                    _set(s, i, center, 0.2, METAL, albedo,
                         fuzz=0.5 * rng.random())
                else:
                    _set(s, i, center, 0.2, DIELECTRIC, ior=1.5)
    i = n - 3
    _set(s, i, (0.0, 1.0, 0.0), 1.0, DIELECTRIC, ior=1.5)
    _set(s, i + 1, (-4.0, 1.0, 0.0), 1.0, LAMBERTIAN, (0.4, 0.2, 0.1))
    _set(s, i + 2, (4.0, 1.0, 0.0), 1.0, METAL, (0.7, 0.6, 0.5), fuzz=0.0)
    return _leaves(s)


def random_spheres(n_spheres: int, seed: int, half_extent: float = 50.0,
                   pad: int = 128) -> dict:
    """n spheres of radius 0.15-0.35 resting on the ground over
    [-half_extent, half_extent]^2, 80% diffuse, 15% metal, 5% glass, plus
    the ground sphere in slot 0."""
    n = n_spheres + 1
    s = _empty(_round_up(n, pad))
    rng = np.random.default_rng(seed)
    m = n_spheres
    s["center"][0] = (0.0, -1000.0, 0.0)
    s["radius"][0] = 1000.0
    s["albedo"][0] = (0.5, 0.5, 0.5)
    s["active"][0] = True
    r = rng.uniform(0.15, 0.35, m)
    s["center"][1:n, 0] = rng.uniform(-half_extent, half_extent, m)
    s["center"][1:n, 2] = rng.uniform(-half_extent, half_extent, m)
    s["center"][1:n, 1] = r
    s["radius"][1:n] = r
    roll = rng.uniform(0.0, 1.0, m)
    lam, met, die = roll < 0.8, (roll >= 0.8) & (roll < 0.95), roll >= 0.95
    s["mat"][1:n][met] = METAL
    s["mat"][1:n][die] = DIELECTRIC
    s["albedo"][1:n][lam] = (rng.uniform(0, 1, (m, 3))
                             * rng.uniform(0, 1, (m, 3)))[lam]
    s["albedo"][1:n][met] = rng.uniform(0.5, 1.0, (m, 3))[met]
    s["fuzz"][1:n][met] = rng.uniform(0.0, 0.5, m)[met]
    s["ior"][1:n][die] = 1.5
    s["active"][1:n] = True
    return _leaves(s)


BUILDERS = {"cover": cover, "random_spheres": random_spheres}
