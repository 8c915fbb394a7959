"""The plain PyTorch path tracer: the oracle every kernel is held to.

The port of ``raytracingincuda_tpu/ops/tracer.py``: pixel chunks, a
sequential loop over samples, and a lane-masked loop over bounces with
the (spheres, rays) hit test and the all-material scatter. All
randomness is counter-based on (pixel, sample, bounce, draw), so results
are bit-identical under any chunk size.

Frozen deviations from the reference, as in the JAX package: the sky uses
the current bounce direction (``legacy_sky=True`` reproduces the CUDA
variants' primary-ray quirk), and the sky blend runs in the working dtype.

``render(dtype=torch.float64)`` is the f64 oracle, the JAX package's
native-f64 oracle (``tracer.render(dtype=jnp.float64)``): the geometry,
the samplers' trig and sqrt, the sky and the sums in double, the uniforms
the f32 mantissa fill cast to double. ``mesh`` renders this rank's slice
of the pixels (``parallel/mesh.py``) and assembles the image on every
rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models import materials
from ..models.camera import (Camera, CameraConfig, config_from_leaves,
                             config_leaves, initialize)
from ..models.scene import Scene, round_up, param_leaves, params_from_leaves
from ..parallel import mesh as meshlib
from . import f32math
from . import rng as rtrng
from . import vec
from .intersect import gather_hit_params, hit_world
from .vec import Vec3

DEFAULT_CHUNK_PIXELS = 8192

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)


class RayState(NamedTuple):
    origin: Vec3
    direction: Vec3
    attenuation: Vec3
    radiance: Vec3
    alive: torch.Tensor


def camera_to(cam: Camera, device) -> Camera:
    """The derived camera's scalars moved to ``device``."""
    return Camera(*(Vec3(*(t.to(device) for t in v)) for v in cam[:-1]),
                  cam.use_defocus.to(device))


def primary_ray_draws(pixel_ids, sample_idx, key, dtype=torch.float32):
    """The primary ray's draws: pixel jitter (u0, u1) and the defocus
    disk point (px, py), functions of (pixel, sample) only."""
    u0, u1 = rtrng.uniform2(key, pixel_ids, sample_idx, 0, rtrng.DRAW_JITTER,
                            dtype)
    px, py = rtrng.random_in_unit_disk(key, pixel_ids, sample_idx, dtype)
    return u0, u1, px, py


def primary_rays_from_ij(cam: Camera, i, j, pixel_ids, sample_idx, key):
    """Jittered, defocus-blurred camera rays from pixel coordinates (column
    ``i``, row ``j``, in the working dtype) and the int pixel ids that key
    the RNG."""
    u0, u1, px, py = primary_ray_draws(pixel_ids, sample_idx, key, i.dtype)
    off_x = u0 - 0.5
    off_y = u1 - 0.5
    pixel_sample = (
        cam.pixel00_loc
        + cam.pixel_delta_u * (i + off_x)
        + cam.pixel_delta_v * (j + off_y)
    )
    defocus_origin = cam.center + cam.defocus_disk_u * px + cam.defocus_disk_v * py
    center = Vec3(*(c.expand(pixel_ids.shape) for c in cam.center))
    origin = vec.where(cam.use_defocus, defocus_origin, center)
    return origin, pixel_sample - origin


def make_primary_rays(cam: Camera, pixel_ids, img_width: int, sample_idx, key):
    dtype = cam.center.x.dtype
    i = (pixel_ids % img_width).to(dtype)
    j = torch.div(pixel_ids, img_width, rounding_mode="floor").to(dtype)
    return primary_rays_from_ij(cam, i, j, pixel_ids, sample_idx, key)


def sky_color(direction: Vec3) -> Vec3:
    """Blue-to-white background gradient, in the direction's dtype."""
    ud = vec.unit(direction)
    a = 0.5 * (ud.y + 1.0)
    kw = dict(dtype=a.dtype, device=a.device)
    white = Vec3.full(a.shape, *SKY_WHITE, **kw)
    blue = Vec3.full(a.shape, *SKY_BLUE, **kw)
    return vec.lerp(a, white, blue)


def linear_to_gamma(x: torch.Tensor) -> torch.Tensor:
    """Gamma 2: sqrt of positive values, 0 at and below black."""
    pos = x > 0.0
    return torch.where(pos, f32math.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def shade_hit(scene: Scene, o: Vec3, d: Vec3, pixel_ids, sample_idx,
              bounce, key, closest=None):
    """Closest hit -> hit point -> oriented normal (signed radius) -> RNG
    draws -> material scatter. Returns (hit, p, scatter result).
    ``closest``: a precomputed ``HitResult`` over ``scene``'s slots (the
    stream walk's); by default ``hit_world``'s."""
    hit, t, idx = hit_world(scene, o, d) if closest is None else closest
    hp = gather_hit_params(scene, idx)

    t_safe = torch.where(hit, t, torch.ones_like(t))
    p = o + d * t_safe
    outward = (p - hp.center) / vec.safe_radius(hp.radius)
    front_face = vec.dot(d, outward) < 0.0
    normal = vec.where(front_face, outward, -outward)

    dtype = d.x.dtype
    unit_rand = rtrng.random_unit_vector(
        key, pixel_ids, sample_idx, bounce, rtrng.DRAW_SCATTER, dtype
    )
    coin_u, _ = rtrng.uniform2(key, pixel_ids, sample_idx, bounce,
                               rtrng.DRAW_COIN, dtype)
    sc = materials.scatter(d, normal, front_face, hp.mat_type, hp.albedo,
                           hp.fuzz, hp.ior, unit_rand, coin_u)
    return hit, p, sc


def trace_sample(
    scene: Scene,
    cam: Camera,
    pixel_ids: torch.Tensor,
    img_width: int,
    sample_idx: int,
    key,
    max_depth: int,
    legacy_sky: bool = False,
    rr_start=None,
) -> Vec3:
    """Radiance of one sample for a flat batch of rays: a miss banks
    attenuation * sky and ends the lane; an absorbed lane banks nothing;
    a lane still alive after ``max_depth`` bounces contributes black."""
    r, dev = pixel_ids.shape, pixel_ids.device
    origin, direction = make_primary_rays(cam, pixel_ids, img_width,
                                          sample_idx, key)
    kw = dict(dtype=direction.x.dtype, device=dev)
    primary_dir = direction
    s = RayState(
        origin=origin,
        direction=direction,
        attenuation=Vec3.full(r, 1.0, 1.0, 1.0, **kw),
        radiance=Vec3.zeros(r, **kw),
        alive=torch.ones(r, dtype=torch.bool, device=dev),
    )
    zero = Vec3.zeros(r, **kw)
    for bounce in range(max_depth):
        hit, p, sc = shade_hit(scene, s.origin, s.direction, pixel_ids,
                               sample_idx, bounce, key)
        sky = sky_color(primary_dir if legacy_sky else s.direction)
        miss_now = s.alive & ~hit
        radiance = s.radiance + vec.where(miss_now, s.attenuation * sky, zero)

        scattered_alive = s.alive & hit & sc.scattered
        atten_upd = s.attenuation * sc.attenuation
        if rr_start is not None and bounce >= rr_start:
            # Russian roulette: survive with p = max-channel throughput
            # (clipped to [0.05, 1]) and reweight survivors by 1/p
            p_surv = vec.clip(
                torch.maximum(torch.maximum(atten_upd.x, atten_upd.y),
                              atten_upd.z),
                0.05, 1.0,
            )
            u_rr, _ = rtrng.uniform2(key, pixel_ids, sample_idx, bounce,
                                     rtrng.DRAW_RR, kw["dtype"])
            scattered_alive = scattered_alive & ~(u_rr >= p_surv)
            atten_upd = atten_upd * (1.0 / p_surv)
        s = RayState(
            origin=vec.where(scattered_alive, p, s.origin),
            direction=vec.where(scattered_alive, sc.direction, s.direction),
            attenuation=vec.where(scattered_alive, atten_upd, s.attenuation),
            radiance=radiance,
            alive=scattered_alive,
        )
    return s.radiance


def _working(scene: Scene, cam_cfg: CameraConfig, dtype, mesh):
    """The scene's and camera's float leaves in ``dtype`` (the identity at
    their own dtype), with their gradients summed over the ranks of
    ``mesh``, whose ranks each differentiate their own pixels."""
    p, c = param_leaves(scene.params), config_leaves(cam_cfg)
    leaves = meshlib.reduce_grads(mesh, [t.to(dtype) for t in p + c])
    return (Scene(params_from_leaves(leaves[:9]), scene.mat_type,
                  scene.active), config_from_leaves(leaves[9:]))


def render(
    scene: Scene,
    cam_cfg: CameraConfig,
    img_width: int,
    img_height: int,
    samples_per_pixel: int,
    max_depth: int,
    *,
    seed: int = rtrng.DEFAULT_SEED,
    dtype=torch.float32,
    chunk_pixels: Optional[int] = None,
    legacy_sky: bool = False,
    gamma: bool = True,
    sample_offset: int = 0,
    accumulate_only: bool = False,
    rr_start=None,
    mesh=None,
) -> torch.Tensor:
    """Render the image on the scene's device; returns (H, W, 3) in
    ``dtype``, float32 or float64 (the scene and camera are cast to it, a
    differentiable cast).

    Pixels go in chunks of ``chunk_pixels`` rays; within a chunk the
    samples ``[sample_offset, sample_offset + samples_per_pixel)``
    accumulate in order. ``accumulate_only`` returns the raw radiance sum
    of that range (no 1/spp, no gamma), so incremental renders add up to
    the single-pass render exactly. ``mesh`` (``parallel.mesh.Mesh``):
    this rank traces its slice of the pixels, padded to 128 lanes a rank,
    in chunks; the image reaches every rank (one ``all_reduce``), the same
    bits as one process renders, and gradients through it are summed over
    the ranks (one ``all_reduce`` in the backward pass)."""
    rtrng.validate_stream_ids(sample_offset + samples_per_pixel, max_depth)
    rr_start = rtrng.validate_rr_start(rr_start)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype!r}")
    key = rtrng.key_from_seed(seed)
    dev = scene.mat_type.device
    scene, cam_cfg = _working(scene, cam_cfg, dtype, mesh)
    cam = camera_to(initialize(cam_cfg, img_width, img_height), dev)

    num_pixels = img_width * img_height
    chunk = chunk_pixels or min(DEFAULT_CHUNK_PIXELS, round_up(num_pixels, 256))
    if meshlib.sharded(mesh):
        padded = meshlib.padded_lanes(num_pixels, mesh)
    else:
        padded = round_up(num_pixels, chunk)
    ids = torch.arange(padded, dtype=torch.int64, device=dev)
    ids = ids[meshlib.local_slice(padded, mesh)]

    out = []
    for ids_chunk in ids.split(chunk):
        acc = Vec3.zeros(ids_chunk.shape, dtype=dtype, device=dev)
        for s in range(sample_offset, sample_offset + samples_per_pixel):
            acc = acc + trace_sample(scene, cam, ids_chunk, img_width, s, key,
                                     max_depth, legacy_sky, rr_start)
        out.append(acc.stack(0))
    img = meshlib.gather_lanes(mesh, torch.cat(out, dim=1), padded)
    img = img.t()[:num_pixels]
    if not accumulate_only:
        img = img * (1.0 / samples_per_pixel)
        if gamma:
            img = linear_to_gamma(img)
    return img.reshape(img_height, img_width, 3)
