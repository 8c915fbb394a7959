"""Scene construction: SoA sphere worlds for the three reference scenes.

The builder is the JAX package's numpy PCG64 builder
(``raytracingincuda_tpu/models/scene.py``) unchanged, so every array here
equals the JAX one bit for bit; only the final containers are torch
tensors. Inactive slots (grid cells the distance filter skips, and the
padding) sit far below the world with an explicit ``active`` mask.

Scene ids: 1 — book cover, 22x22 grid (488 slots); 2 — off-center 6x6
patch (40 slots); any other — 11x11 quadrant (125 slots).

Every factory builds on the card unless the caller asks for the CPU:
``device`` None is ``'cuda'``, and without CUDA it raises and names
``device='cpu'`` (``device.resolve_device``), as the JAX package's
``jnp.asarray`` leaves land on its default accelerator.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.rng import DEFAULT_SEED
from ..ops.vec import Vec3

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2


class SceneParams(NamedTuple):
    center: Vec3            # (N,) each
    radius: torch.Tensor    # (N,)
    albedo: Vec3            # (N,) each
    fuzz: torch.Tensor      # (N,)
    ior: torch.Tensor       # (N,)


def param_leaves(p: SceneParams) -> list:
    """The 9 tensors of a SceneParams in the JAX pytree's leaf order:
    center x/y/z, radius, albedo x/y/z, fuzz, ior."""
    return [*p.center, p.radius, *p.albedo, p.fuzz, p.ior]


def params_from_leaves(leaves) -> SceneParams:
    """Inverse of ``param_leaves``."""
    cx, cy, cz, radius, ar, ag, ab, fuzz, ior = leaves
    return SceneParams(Vec3(cx, cy, cz), radius, Vec3(ar, ag, ab), fuzz, ior)


class Scene(NamedTuple):
    params: SceneParams
    mat_type: torch.Tensor  # (N,) int32
    active: torch.Tensor    # (N,) bool

    @property
    def num_slots(self) -> int:
        return self.mat_type.shape[0]


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class _Builder:
    def __init__(self, n_slots: int):
        self.center = np.zeros((n_slots, 3), np.float64)
        self.center[:, 1] = -1.0e6
        self.radius = np.full(n_slots, 1.0, np.float64)
        self.albedo = np.zeros((n_slots, 3), np.float64)
        self.fuzz = np.zeros(n_slots, np.float64)
        self.ior = np.ones(n_slots, np.float64)
        self.mat = np.zeros(n_slots, np.int32)
        self.active = np.zeros(n_slots, bool)

    def set(self, i, center, radius, mat, albedo=(0, 0, 0), fuzz=0.0, ior=1.0):
        self.center[i] = center
        self.radius[i] = radius
        self.mat[i] = mat
        self.albedo[i] = albedo
        self.fuzz[i] = min(fuzz, 1.0)  # metal constructor clamp
        self.ior[i] = ior
        self.active[i] = True


def _fill_small_spheres(b: _Builder, rng: np.random.Generator,
                        a_range, b_range, slot_fn):
    """The reference's small-sphere loop, draw order kept."""
    for a in range(*a_range):
        for bb in range(*b_range):
            choose_mat = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()]
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) > 0.9:
                i = slot_fn(a, bb)
                if choose_mat < 0.8:
                    albedo = rng.random(3) * rng.random(3)
                    b.set(i, center, 0.2, LAMBERTIAN, albedo)
                elif choose_mat < 0.95:
                    albedo = 0.5 + 0.5 * rng.random(3)
                    fuzz = 0.5 * rng.random()
                    b.set(i, center, 0.2, METAL, albedo, fuzz=fuzz)
                else:
                    b.set(i, center, 0.2, DIELECTRIC, ior=1.5)


def num_slots_for_scene(scene_id: int) -> int:
    """1 ground + grid slots + 3 big spheres."""
    if scene_id == 1:
        return 1 + 22 * 22 + 3
    if scene_id == 2:
        return 1 + 6 * 6 + 3
    return 1 + 11 * 11 + 3


def to_scene(center, radius, albedo, fuzz, ior, mat, active, dtype,
              device) -> Scene:
    device = resolve_device(device)

    def t(a):  # float64 -> dtype rounds to nearest, as numpy and JAX do
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return Scene(
        params=SceneParams(
            center=Vec3(*(t(center[:, k]) for k in range(3))),
            radius=t(radius),
            albedo=Vec3(*(t(albedo[:, k]) for k in range(3))),
            fuzz=t(fuzz),
            ior=t(ior),
        ),
        mat_type=torch.from_numpy(np.asarray(mat, np.int32)).to(device),
        active=torch.from_numpy(np.asarray(active, bool)).to(device),
    )


def build_scene(
    scene_id: int,
    seed: int = DEFAULT_SEED,
    dtype=torch.float32,
    pad_to_multiple: Optional[int] = 128,
    device=None,
) -> Scene:
    """One of the three reference scenes as a padded SoA scene on
    ``device`` (None: the card); ``pad_to_multiple`` rounds the slot count
    up with inactive padding."""
    n = num_slots_for_scene(scene_id)
    n_padded = round_up(n, pad_to_multiple) if pad_to_multiple else n
    b = _Builder(n_padded)
    rng = np.random.default_rng(seed)

    b.set(0, (0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5))
    if scene_id == 1:
        _fill_small_spheres(
            b, rng, (-11, 11), (-11, 11),
            lambda a, bb: (a + 11) * 22 + (bb + 11) + 1,
        )
    elif scene_id == 2:
        _fill_small_spheres(
            b, rng, (5, 11), (5, 11),
            lambda a, bb: (a - 5) * 6 + (bb - 5) + 1,
        )
    else:
        _fill_small_spheres(
            b, rng, (-11, 0), (-11, 0),
            lambda a, bb: (a + 11) * 11 + (bb + 11) + 1,
        )

    i = n - 3
    b.set(i, (0.0, 1.0, 0.0), 1.0, DIELECTRIC, ior=1.5)
    b.set(i + 1, (-4.0, 1.0, 0.0), 1.0, LAMBERTIAN, (0.4, 0.2, 0.1))
    b.set(i + 2, (4.0, 1.0, 0.0), 1.0, METAL, (0.7, 0.6, 0.5), fuzz=0.0)
    return to_scene(b.center, b.radius, b.albedo, b.fuzz, b.ior, b.mat,
                     b.active, dtype, device)


def build_random_scene(
    n_spheres: int,
    seed: int = DEFAULT_SEED,
    dtype=torch.float32,
    pad_to_multiple: Optional[int] = 128,
    half_extent: float = 50.0,
    device=None,
) -> Scene:
    """A large random scene with the reference's material mix, scattered
    uniformly over a [-half_extent, half_extent]^2 ground patch, plus the
    ground sphere (the same vectorized numpy draws as the JAX package), on
    ``device`` (None: the card)."""
    n = n_spheres + 1
    n_padded = round_up(n, pad_to_multiple) if pad_to_multiple else n
    rng = np.random.default_rng(seed)
    m = n_spheres

    center = np.zeros((n_padded, 3), np.float64)
    center[:, 1] = -1e6
    radius = np.ones(n_padded)
    albedo = np.zeros((n_padded, 3))
    fuzz = np.zeros(n_padded)
    ior = np.ones(n_padded)
    mat = np.zeros(n_padded, np.int32)
    active = np.zeros(n_padded, bool)

    center[0] = (0.0, -1000.0, 0.0)
    radius[0] = 1000.0
    albedo[0] = (0.5, 0.5, 0.5)
    active[0] = True

    r = rng.uniform(0.15, 0.35, m)
    center[1:n, 0] = rng.uniform(-half_extent, half_extent, m)
    center[1:n, 2] = rng.uniform(-half_extent, half_extent, m)
    center[1:n, 1] = r
    radius[1:n] = r
    roll = rng.uniform(0.0, 1.0, m)
    lam = roll < 0.8
    met = (roll >= 0.8) & (roll < 0.95)
    die = roll >= 0.95
    mat[1:n][met] = METAL
    mat[1:n][die] = DIELECTRIC
    albedo[1:n][lam] = (rng.uniform(0, 1, (m, 3))
                        * rng.uniform(0, 1, (m, 3)))[lam]
    albedo[1:n][met] = rng.uniform(0.5, 1.0, (m, 3))[met]
    fuzz[1:n][met] = rng.uniform(0.0, 0.5, m)[met]
    ior[1:n][die] = 1.5
    active[1:n] = True
    return to_scene(center, radius, albedo, fuzz, ior, mat, active, dtype,
                     device)


def build_deep_scene(dtype=torch.float32, pad_to_multiple: Optional[int] = 8,
                     device=None) -> Scene:
    """A scene on ``device`` (None: the card) whose paths run deep, for
    the train kernels' deep stack: a
    diffuse core (radius 2, albedo 0.99/0.96/0.93) inside a concentric
    glass shell (radius 2.2, ior 4), centred 2.1 from the reference
    camera's eye along its view, so that the camera looks from the gap
    between them. A path that meets the shell more than 14.5 degrees from
    its normal is held by total internal reflection; a path banks its
    radiance only when it escapes through the shell (at 8x4x2spp, depth
    256, 15 of the 61 banking paths end beyond bounce 64 at parity)."""
    eye = np.array([13.0, 2.0, 3.0])
    centre = eye - eye / np.linalg.norm(eye) * 2.1
    n = 2
    n_padded = round_up(n, pad_to_multiple) if pad_to_multiple else n
    center = np.zeros((n_padded, 3))
    center[:, 1] = -1e6
    center[:n] = centre
    radius = np.ones(n_padded)
    radius[:n] = (2.0, 2.2)
    albedo = np.zeros((n_padded, 3))
    albedo[0] = (0.99, 0.96, 0.93)
    ior = np.ones(n_padded)
    ior[1] = 4.0
    mat = np.zeros(n_padded, np.int32)
    mat[1] = DIELECTRIC
    active = np.arange(n_padded) < n
    return to_scene(center, radius, albedo, np.zeros(n_padded), ior, mat,
                     active, dtype, device)
