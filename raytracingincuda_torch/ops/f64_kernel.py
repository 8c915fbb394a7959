"""The forward render in double precision (``dtype='float64'``).

The counterpart of ``raytracingincuda_tpu/ops/pallas_df64.py`` and
``ops/df64_trace.py``. The TPU has no FP64 units, so the JAX package
carries every value as an f32 hi/lo pair (double-float, about 48
significand bits); the H100 has FP64 units, and the port computes in
native ``double``. Its hi/lo arithmetic (``ops/df64.py``) has no
counterpart here.

Two implementations share one signature:

  * ``f64_kernel`` launches the hand-written CUDA kernel
    (``csrc/f64_render.cu``, one thread per pixel) on CUDA tensors;
  * ``f64_reference`` is the plain PyTorch version: the JAX
    ``regen_trace_df64`` recurrence, one wave at a time over all lanes, in
    ``torch.float64``.

``_f64`` (``kernel_io.by_device``) picks the kernel for CUDA tensors and
the plain version only for CPU tensors; nothing falls back from one to the
other. ``render_f64`` is the ``render_pallas_df64`` counterpart.

Where ``group_scan.uses_groups`` holds (layout ``'vmem'``, 2 * ``GROUP`` to
``MAX_SLOTS`` slots) the kernel's closest hit walks the group table in
two levels, in double (``csrc/f64_render.cu``'s header); the plain
version keeps the brute-force scan, and the image is the same bits. Its
count mode (``f64_counts``, plain version ``f64_counts_reference``, which
runs ``group_scan.model_scan`` in double over ``f64_wave_rays``' rays)
counts what each warp's scan tests.

The df64 contract holds: the camera row, the geometry, attenuation, the
sky and the sums are double, and the random draws are the f32 Threefry
values of ``ops/rng.py`` and ``ops/f32math.py``, promoted exactly (the
jitter, the defocus disk, the unit vector and the coin). Every expression
keeps ``df64_trace.py``'s association: the sample position
``fi + (u0 - 0.5)`` in double, ``t = t_num / a`` as a division, dot
products left to right, ``c = (c2r2 + |O|^2) - 2 C.O``, Schlick's
``(om2 * om2) * om``, ``unit(v) = v * (1 / sqrt(max(|v|^2, 1e-30)))``.
The scope is the df64 path's: parity estimator, current-bounce sky,
uniform budgets. The closest hit keeps the first slot at an exact tie,
where the JAX kernel blends tied slots through its one-hot gather.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.camera import CameraConfig, initialize_f64
from ..models.scene import LAMBERTIAN, METAL, DIELECTRIC, Scene
from ..utils import trace
from . import f32math, group_scan
from . import kernel_io as kio
from . import rng as rtrng
from . import vec
from .intersect import T_MIN, T_MISS
from .tracer import primary_ray_draws
from .vec import Vec3

F64 = torch.float64
# (spheres x lanes) double temporaries of the plain version per chunk
_REFERENCE_CHUNK_ELEMS = 1 << 23


# The correctly rounded double sqrt on every device, as the kernel's
# ``sqrt`` (f32math: numpy's on the CPU, torch's on the card).
_sqrt = f32math.sqrt


def _unit(v: Vec3) -> Vec3:
    return v * (1.0 / _sqrt(vec.maximum(vec.length_sq(v), 1e-30)))


def _promote(v: Vec3) -> Vec3:
    return Vec3(v.x.to(F64), v.y.to(F64), v.z.to(F64))


def _primary(cam: dict, fi, fj, pid, sample, key):
    """df64_trace.primary_rays_df64: f32 draws, double geometry."""
    u0, u1, px, py = primary_ray_draws(pid, sample, key)
    ix = fi + (u0 - 0.5).to(F64)
    jy = fj + (u1 - 0.5).to(F64)
    pixel_sample = cam["pixel00"] + cam["du"] * ix + cam["dv"] * jy
    center = Vec3(*(c.expand(pid.shape) for c in cam["center"]))
    origin = (cam["center"] + cam["disk_u"] * px.to(F64)
              + cam["disk_v"] * py.to(F64)) if cam["defocus"] else center
    return origin, pixel_sample - origin


def _hit(cols, o: Vec3, d: Vec3):
    """df64_trace.hit_world_df64 in double: (hit, t = t_num / a, slot)."""
    cx, cy, cz, r, active = cols["cx"], cols["cy"], cols["cz"], cols["r"], \
        cols["active"]
    ox, oy, oz = o.x[None], o.y[None], o.z[None]
    dx, dy, dz = d.x[None], d.y[None], d.z[None]
    a = vec.maximum(dx * dx + dy * dy + dz * dz, 1e-12)
    d_dot_o = dx * ox + dy * oy + dz * oz
    o2 = ox * ox + oy * oy + oz * oz
    c_dot_d = cx * dx + cy * dy + cz * dz
    c_dot_o = cx * ox + cy * oy + cz * oz
    c2r2 = cx * cx + cy * cy + cz * cz - r * r
    h = c_dot_d - d_dot_o
    c = (c2r2 + o2) - 2.0 * c_dot_o
    disc = h * h - a * c
    disc_pos = disc > 0.0
    sqrtd = _sqrt(torch.where(disc_pos, disc, torch.ones_like(disc)))
    tmin_a = T_MIN * a
    near = h - sqrtd
    root = torch.where(near > tmin_a, near, h + sqrtd)
    valid = disc_pos & (root > tmin_a) & active
    t_num, idx = torch.min(torch.where(valid, root, T_MISS), dim=0)
    hit = t_num < T_MISS
    return hit, t_num / a[0], idx


def _scatter(d: Vec3, normal: Vec3, front, mat, albedo: Vec3, fuzz, ior,
             ur: Vec3, coin) -> tuple:
    """df64_trace.scatter_df64 in double: (direction, attenuation,
    scattered)."""
    lam = normal + ur
    lam = vec.where(vec.near_zero(lam), normal, lam)
    metal = _unit(vec.reflect(d, normal)) + ur * fuzz
    metal_ok = vec.dot(metal, normal) > 0.0

    ri = torch.where(front, 1.0 / ior, ior)
    ud = _unit(d)
    cos_t = vec.minimum(vec.dot(-ud, normal), 1.0)
    sin_t = _sqrt(vec.maximum(1.0 - cos_t * cos_t, 0.0))
    cannot = ri * sin_t > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    om = 1.0 - cos_t
    om2 = om * om
    reflect_coin = r0 + (1.0 - r0) * ((om2 * om2) * om) > coin
    perp = (ud + normal * cos_t) * ri
    par = _sqrt(vec.maximum((1.0 - vec.length_sq(perp)).abs(), 1e-12))
    diel = vec.where(cannot | reflect_coin, vec.reflect(ud, normal),
                     perp + normal * (-par))

    is_metal = mat == METAL
    direction = vec.where(mat == LAMBERTIAN, lam,
                          vec.where(is_metal, metal, diel))
    one = torch.ones_like(fuzz)
    attenuation = vec.where(mat == DIELECTRIC, Vec3(one, one, one), albedo)
    return direction, attenuation, metal_ok | ~is_metal


def _sky(d: Vec3) -> Vec3:
    """df64_trace.sky_color_df64: (1 - a) * white + a * blue."""
    uy = d.y * (1.0 / _sqrt(vec.maximum(vec.length_sq(d), 1e-30)))
    a = 0.5 * (uy + 1.0)
    w = 1.0 - a
    return Vec3(w * 1.0 + a * 0.5, w * 1.0 + a * 0.7, w * 1.0 + a * 1.0)


def f64_reference(ids, ii, jj, scene_mat, cam_row, *, samples: int,
                  max_depth: int, seed: int = rtrng.DEFAULT_SEED,
                  sample_offset: int = 0,
                  layout: str = "vmem") -> torch.Tensor:
    """Plain PyTorch version of the f64 kernel.

    Lane ``i`` renders pixel ``ids[i]`` (column ``ii[i]``, row ``jj[i]``)
    over samples ``[sample_offset, sample_offset + samples)``, its draws
    keyed on the absolute sample index, with the (N, 16) f32 scene matrix
    and the (24,) float64 camera row of ``models.camera.initialize_f64``.
    Returns the (3, padded) float64 radiance sums. ``layout`` only
    changes where the kernel keeps the scene."""
    kio.check(ids, ii, jj, scene_mat, cam_row, samples=samples,
              max_depth=max_depth, sample_offset=sample_offset,
              layout=layout, cam_dtype=F64)
    sm = scene_mat.to(F64)
    cols, cam = _columns(sm, scene_mat), _camera(cam_row)
    chunk = kio.reference_chunk(scene_mat.shape[0], _REFERENCE_CHUNK_ELEMS)
    return torch.cat([
        _f64_lanes(*lanes, sm, cols, cam, samples=samples,
                   max_depth=max_depth, seed=seed,
                   sample_offset=sample_offset)
        for lanes in zip(ids.split(chunk), ii.split(chunk), jj.split(chunk))
    ], dim=1)


def _columns(sm, scene_mat) -> dict:
    """The hit test's (N, 1) double columns and active mask."""
    return {"cx": sm[:, kio.COL_CX, None], "cy": sm[:, kio.COL_CY, None],
            "cz": sm[:, kio.COL_CZ, None], "r": sm[:, kio.COL_RADIUS, None],
            "active": scene_mat[:, kio.COL_ACTIVE, None] > 0.5}


def _camera(c) -> dict:
    """The (24,) double camera row's vectors."""
    v3 = lambda k: Vec3(c[k], c[k + 1], c[k + 2])  # noqa: E731
    return {"pixel00": v3(0), "du": v3(3), "dv": v3(6), "center": v3(9),
            "disk_u": v3(12), "disk_v": v3(15), "defocus": bool(c[18] > 0.5)}


def _f64_lanes(ids, fi, fj, sm, cols, cam, *, samples, max_depth, seed,
               sample_offset, wave_fn=None):
    """The regen_trace_df64 recurrence over one chunk of lanes; the
    sample counter starts at ``sample_offset``. ``wave_fn(o, d, active)``
    sees each wave's rays and the lanes that trace in it."""
    key = rtrng.key_from_seed(seed)
    pid = ids.to(torch.int64)
    fi, fj = fi.to(F64), fj.to(F64)
    shape, dev = pid.shape, pid.device
    one3 = Vec3.full(shape, 1.0, 1.0, 1.0, dtype=F64, device=dev)
    end = sample_offset + samples
    sample = torch.full(shape, sample_offset, dtype=torch.int64, device=dev)
    bounce = torch.zeros_like(sample)
    o, d = _primary(cam, fi, fj, pid, sample, key)
    atten, acc = one3, Vec3.zeros(shape, dtype=F64, device=dev)
    col = lambda k, idx: sm[idx, k]  # noqa: E731

    for _ in range(samples * max_depth):
        active = sample < end
        if not bool(active.any()):
            break
        if wave_fn is not None:
            wave_fn(o, d, active)
        hit, t, idx = _hit(cols, o, d)
        p = o + d * torch.where(hit, t, 1.0)
        center = Vec3(col(kio.COL_CX, idx), col(kio.COL_CY, idx),
                      col(kio.COL_CZ, idx))
        outward = (p - center) * (1.0 / vec.safe_radius(col(kio.COL_RADIUS,
                                                            idx)))
        front = vec.dot(d, outward) < 0.0
        normal = vec.where(front, outward, -outward)
        ur = _promote(rtrng.random_unit_vector(key, pid, sample, bounce,
                                               rtrng.DRAW_SCATTER))
        coin, _ = rtrng.uniform2(key, pid, sample, bounce, rtrng.DRAW_COIN)
        albedo = Vec3(col(kio.COL_ALB_R, idx), col(kio.COL_ALB_G, idx),
                      col(kio.COL_ALB_B, idx))
        direction, att, scattered = _scatter(
            d, normal, front, col(kio.COL_MAT, idx).to(torch.int32), albedo,
            col(kio.COL_FUZZ, idx), col(kio.COL_IOR, idx), ur, coin.to(F64))

        # scattering at the depth cap exits black
        continues = active & hit & scattered & (bounce < max_depth - 1)
        dies = active & ~continues
        miss = active & ~hit
        acc = vec.where(miss, acc + atten * _sky(d), acc)

        o = vec.where(continues, p, o)
        d = vec.where(continues, direction, d)
        atten = vec.where(continues, atten * att, atten)
        bounce = torch.where(continues, bounce + 1, bounce)

        # dying lanes regenerate with the pixel's next sample
        sample = sample + dies.to(torch.int64)
        o_new, d_new = _primary(cam, fi, fj, pid, sample, key)
        regen = dies & (sample < end)
        o = vec.where(regen, o_new, o)
        d = vec.where(regen, d_new, d)
        atten = vec.where(regen, one3, atten)
        bounce = torch.where(regen, 0, bounce)
    return acc.stack(0)


_C_ARGTYPES = [
    ctypes.c_void_p,   # ids (int32)
    ctypes.c_void_p,   # ii
    ctypes.c_void_p,   # jj
    ctypes.c_void_p,   # scene, SoA (11, N) f32
    ctypes.c_int,      # N
    ctypes.c_void_p,   # cam row (24,) double
    ctypes.c_void_p,   # out (3, padded) double
    ctypes.c_int,      # padded
    ctypes.c_int,      # samples
    ctypes.c_int,      # max_depth
    ctypes.c_uint32,   # key word 0
    ctypes.c_uint32,   # key word 1
    ctypes.c_int,      # sample_offset
    ctypes.c_int,      # hbm layout
    ctypes.c_void_p,   # group table (null: the one-level scan)
]


def _table(soa, cam_row, layout: str) -> Optional[torch.Tensor]:
    """The group table a launch over the (11, N) SoA scene scans with
    (``group_scan.group_table``; its order reads the camera centre from an
    f32 copy of the double row, made on the card), or None: one level."""
    if not group_scan.uses_groups(soa.shape[1], layout):
        return None
    return group_scan.group_table(soa, cam_row.to(torch.float32), layout)


@trace.spanned("rt.launch.f64_render")
def f64_kernel(ids, ii, jj, scene_mat, cam_row, *, samples: int,
               max_depth: int, seed: int = rtrng.DEFAULT_SEED,
               sample_offset: int = 0,
               layout: str = "vmem") -> torch.Tensor:
    """Launch the CUDA f64 kernel; same contract as ``f64_reference``.
    Launches on the current stream without synchronising. Counts
    ``launch.f64_render``, and its scan (``group_scan.count_path``): with
    a group table, built by one launch before it, ``scan.two_level``,
    else ``scan.one_level``."""
    launch = kio.entry("f64_render", _C_ARGTYPES, ids.device)
    kio.check(ids, ii, jj, scene_mat, cam_row, samples=samples,
              max_depth=max_depth, sample_offset=sample_offset,
              layout=layout, cam_dtype=F64)
    padded, n = ids.shape[0], scene_mat.shape[0]
    soa = kio.soa(scene_mat)
    out = torch.empty((3, padded), dtype=F64, device=ids.device)
    k0, k1 = rtrng.key_from_seed(seed)
    groups = _table(soa, cam_row, layout)
    launch(ids.data_ptr(), ii.data_ptr(), jj.data_ptr(), soa.data_ptr(), n,
           cam_row.data_ptr(), out.data_ptr(), padded, samples, max_depth,
           k0, k1, sample_offset, int(layout == "hbm"), kio.at(groups))
    trace.count("launch.f64_render")
    group_scan.count_path(groups)
    return out


_f64 = kio.by_device(f64_kernel, f64_reference)


# f64_counts: f64_render's arguments with the (4, padded) int32 counts
# after out
_COUNT_ARGTYPES = _C_ARGTYPES[:7] + [ctypes.c_void_p] + _C_ARGTYPES[7:]


def f64_counts(ids, ii, jj, scene_mat, cam_row, *, samples: int,
               max_depth: int, seed: int = rtrng.DEFAULT_SEED,
               sample_offset: int = 0, layout: str = "vmem") -> tuple:
    """The kernel's count mode on the card: the render's loop, counting.
    Returns each lane's segments (padded,) f32 and, per warp of 32 lanes,
    each (padded // 32,) int32: the times the warp ran the closest-hit
    scan (as the leader of each group of lanes that ran it together
    counted them), the groups the two-level scan opened, and the slot
    tests it issued (the large entries and ``GROUP`` an opened group a
    scan; every slot a scan of the one-level scan), as
    ``render_kernel.regen_counts`` returns them. ``f64_counts_reference``
    is its plain version."""
    launch = kio.entry("f64_counts", _COUNT_ARGTYPES, ids.device)
    kio.check(ids, ii, jj, scene_mat, cam_row, samples=samples,
              max_depth=max_depth, sample_offset=sample_offset,
              layout=layout, cam_dtype=F64)
    padded, n = ids.shape[0], scene_mat.shape[0]
    soa = kio.soa(scene_mat)
    out = torch.empty((3, padded), dtype=F64, device=ids.device)
    counts = torch.empty((4, padded), dtype=torch.int32, device=ids.device)
    k0, k1 = rtrng.key_from_seed(seed)
    groups = _table(soa, cam_row, layout)
    launch(ids.data_ptr(), ii.data_ptr(), jj.data_ptr(), soa.data_ptr(), n,
           cam_row.data_ptr(), out.data_ptr(), counts.data_ptr(), padded,
           samples, max_depth, k0, k1, sample_offset, int(layout == "hbm"),
           kio.at(groups))
    group_scan.count_path(groups)
    issues, opened, tests = (c.view(-1, kio.WARP).sum(1).to(torch.int32)
                             for c in counts[1:])
    if groups is None:      # the one-level scan tests every slot an issue
        tests = issues * n
    return counts[0].float(), issues, opened, tests


def f64_wave_rays(ids, ii, jj, scene_mat, cam_row, fn, *, samples: int,
                  max_depth: int, seed: int = rtrng.DEFAULT_SEED,
                  sample_offset: int = 0) -> None:
    """Run the plain version's recurrence over all lanes at once and call
    ``fn(o, d, active)`` with each wave's double rays (``Vec3`` over the
    lanes) and the lanes that trace in it. Lane i of a wave is the i-th
    lane of the kernel's loop at that iteration."""
    kio.check(ids, ii, jj, scene_mat, cam_row, samples=samples,
              max_depth=max_depth, sample_offset=sample_offset,
              cam_dtype=F64)
    sm = scene_mat.to(F64)
    _f64_lanes(ids, ii, jj, sm, _columns(sm, scene_mat), _camera(cam_row),
               samples=samples, max_depth=max_depth, seed=seed,
               sample_offset=sample_offset, wave_fn=fn)


def f64_counts_reference(ids, ii, jj, scene_mat, cam_row, *, samples: int,
                         max_depth: int, seed: int = rtrng.DEFAULT_SEED,
                         sample_offset: int = 0,
                         layout: str = "vmem") -> tuple:
    """Plain version of the count mode: each lane's segments (padded,)
    f32 (the waves it traces in; a wave is one iteration of every warp's
    loop) and per warp (padded // 32,) int32: the waves in which any of its
    lanes traces, and the groups opened and slot tests of each wave's rays
    through ``group_scan.model_scan`` in double on the table the launch
    would build (``group_table_reference`` with the row's f32 copy,
    ``double_table``), or ``scene_mat``'s slots an issue where the launch
    scans in one level."""
    n = scene_mat.shape[0]
    table = None
    if group_scan.uses_groups(n, layout):
        table = group_scan.double_table(group_scan.unpack(
            group_scan.group_table_reference(
                scene_mat, cam_row.to(torch.float32)[None]), n), scene_mat)
    warps = torch.zeros((ids.shape[0] // kio.WARP,), dtype=torch.int64)
    tot = {"segments": torch.zeros(ids.shape, dtype=torch.int64),
           "issues": warps, "opened": warps, "tests": warps}

    def wave(o, d, active):
        active = active.cpu()
        tot["segments"] = tot["segments"] + active.long()
        tot["issues"] = tot["issues"] + active.view(-1, kio.WARP).any(1)
        if table is not None:
            res = group_scan.model_scan(table, o, d, active)
            tot["opened"] = tot["opened"] + res.opened
            tot["tests"] = tot["tests"] + res.tests

    f64_wave_rays(ids, ii, jj, scene_mat, cam_row, wave, samples=samples,
                  max_depth=max_depth, seed=seed, sample_offset=sample_offset)
    if table is None:
        tot["tests"] = tot["issues"] * n
    dev = ids.device
    return (tot["segments"].to(dev, torch.float32),
            *(tot[k].to(dev, torch.int32) for k in ("issues", "opened",
                                                    "tests")))


def f64_inputs(scene: Scene, cam_cfg: CameraConfig, img_width: int,
               img_height: int, *, pixel_order=None, scene_mat=None) -> tuple:
    """The five tensors both f64 implementations take, on the scene's
    device: (ids, ii, jj, scene_mat, cam_row). ``scene_mat``: the scene
    already packed (``kernel_io.pack_scene_matrix``)."""
    if scene_mat is None:
        scene_mat = kio.pack_scene_matrix(scene)
    dev = scene_mat.device
    cam_row = camera_row(cam_cfg, img_width, img_height, dev)
    ids, ii, jj, _ = kio.lane_setup(img_width, img_height, pixel_order, 1, 0,
                                    None, dev)
    return ids, ii, jj, scene_mat, cam_row


def camera_row(cam_cfg: CameraConfig, img_width: int, img_height: int,
               device) -> torch.Tensor:
    """``initialize_f64``'s (24,) float64 row on ``device``: span
    ``rt.camera``. It reaches a card as ``kernel_io.camera_row``'s does:
    from pinned memory, a copy queued on the current stream that the host
    does not wait for."""
    with trace.span("rt.camera"):
        row = initialize_f64(cam_cfg, img_width, img_height)
        if torch.device(device).type == "cuda":
            return row.pin_memory().to(device, non_blocking=True)
        return row.to(device)


def render_f64(scene: Scene, cam_cfg: CameraConfig, img_width: int,
               img_height: int, samples_per_pixel: int, max_depth: int, *,
               seed: int = rtrng.DEFAULT_SEED, layout: str = "vmem",
               gamma: bool = True, pixel_order: Optional[torch.Tensor] = None,
               scene_mat: Optional[torch.Tensor] = None,
               sample_offset: int = 0,
               accumulate_only: bool = False) -> torch.Tensor:
    """Render in double on the scene's device: (H, W, 3) float64.

    The JAX ``render_pallas_df64`` returns an (H, W, 3) hi/lo pair of f32
    arrays (``df64.to_f64`` adds them); the port returns the double image
    itself. ``pixel_order`` (a (padded,) permutation of pixel ids) orders
    the lanes and the output is un-permuted exactly, so it changes speed
    only. 1/spp and then gamma 2 run in double. ``scene_mat``: the scene
    already packed (``kernel_io.pack_scene_matrix``). The pixels
    render samples ``[sample_offset, sample_offset + samples_per_pixel)``;
    ``accumulate_only`` returns their raw double sums (un-permuted, no
    1/spp, no gamma), a round of ``utils.checkpoint.render_incremental``.
    The JAX
    ``ray_tile`` and ``pixels_per_lane`` shaped the TPU schedule and have
    no counterpart."""
    ids, *rest = f64_inputs(scene, cam_cfg, img_width, img_height,
                            pixel_order=pixel_order, scene_mat=scene_mat)
    acc = _f64(ids, *rest, samples=samples_per_pixel, max_depth=max_depth,
               seed=seed, sample_offset=sample_offset, layout=layout).t()
    if pixel_order is not None:
        out = torch.zeros_like(acc)
        out[ids.long()] = acc
        acc = out
    acc = acc[:img_width * img_height]
    if accumulate_only:
        return acc.reshape(img_height, img_width, 3)
    return finalize(acc, samples_per_pixel, gamma).reshape(img_height,
                                                           img_width, 3)


@trace.spanned("rt.finalize")
def finalize(acc: torch.Tensor, samples: int, gamma: bool = True):
    """``render_f64``'s finish of raw double sums: 1/spp, then gamma 2."""
    img = acc * (1.0 / samples)
    if gamma:
        pos = img > 0.0
        img = torch.where(pos, _sqrt(torch.where(pos, img, 1.0)), 0.0)
    return img
