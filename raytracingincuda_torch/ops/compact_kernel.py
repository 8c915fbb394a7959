"""The forward render by live-ray compaction (``render_kernel(mode='compact')``).

The counterpart of ``raytracingincuda_tpu/ops/pallas_kernel.py``'s
``_render_tile_kernel_compact``: the image of the regeneration kernel,
under the parity estimator and the current-bounce sky, by another
schedule. Per sample, every lane's primary ray enters a pool; each wave
advances the live rays by one bounce, then packs the survivors to the
front of the pool in their order (a stable pack). Each ray carries its
lane id and its banked radiance; after the sample the radiance goes back
to its lane and is added to the lane's sum, in sample order.

Two implementations share one signature:

  * ``compact_kernel`` launches the hand-written CUDA kernel
    (``csrc/compact_render.cu``) on CUDA tensors: a block of 128 lanes
    keeps one ray in flight for each lane with samples left, a lane whose
    path ended starts its next sample in the same pool entry, and the pool
    is packed only in the waves where lanes finished, so warps wholly past
    the live count sit a wave out;
  * ``compact_reference`` is the plain PyTorch version: the JAX compact
    recurrence, one pool over the lanes given.

``_compact`` picks the kernel for CUDA tensors and the plain version only
for CPU tensors; nothing falls back. Each bounce is the regeneration
kernel's arithmetic (``tracer.shade_hit``; ``path_common.cuh``'s
``scatter_bounce`` on the card), and a sample's radiance is added only
where its ray missed, in sample order in both schedules, so the image
equals kernel 1's bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils import trace
from . import group_scan
from . import render_kernel as rk
from . import rng as rtrng
from . import vec
from .tracer import _linear_to_gamma, _sky_color, primary_rays_from_ij, shade_hit
from .vec import Vec3


def _check(ids, ii, jj, scene_mat, cam_row, *, samples, max_depth, layout):
    """Kernel 1's argument rules; ``ii`` stands in for the budget row,
    which the compact kernel has no use for."""
    rk._check_args(ids, ii, jj, ii, scene_mat, cam_row, samples=samples,
                   max_depth=max_depth, rr_start=None, sample_offset=0,
                   layout=layout)


def compact_reference(ids, ii, jj, scene_mat, cam_row, *, samples: int,
                      max_depth: int, seed: int = rtrng.DEFAULT_SEED,
                      finalize_scale: Optional[float] = None,
                      layout: str = "vmem") -> torch.Tensor:
    """Plain PyTorch version of the compact kernel.

    Lane ``i`` renders pixel ``ids[i]`` (column ``ii[i]``, row ``jj[i]``)
    over samples ``[0, samples)``. Returns a (3, padded) f32 radiance sum,
    scaled by ``finalize_scale`` and gamma'd when given. ``layout`` only
    changes where the kernel keeps the scene."""
    _check(ids, ii, jj, scene_mat, cam_row, samples=samples,
           max_depth=max_depth, layout=layout)
    scene = rk.scene_from_matrix(scene_mat)
    cam = rk.unpack_camera(cam_row)
    # lanes are independent: one pool per chunk bounds the temporaries
    chunk = max(rk.PAD, rk._REFERENCE_CHUNK_ELEMS // scene_mat.shape[0]
                // rk.PAD * rk.PAD)
    out = torch.cat([
        _compact_lanes(*lanes, scene, cam, samples=samples,
                       max_depth=max_depth, seed=seed)
        for lanes in zip(ids.split(chunk), ii.split(chunk), jj.split(chunk))
    ], dim=1)
    if finalize_scale is not None:
        out = _linear_to_gamma(out * finalize_scale)
    return out


def _compact_lanes(ids, ii, jj, scene, cam, *, samples, max_depth, seed):
    """The JAX compact recurrence over one pool of lanes; (3, lanes)."""
    key = rtrng.key_from_seed(seed)
    pid = ids.to(torch.int64)
    shape, dev = pid.shape, pid.device
    lanes = torch.arange(shape[0], device=dev)
    acc = Vec3.zeros(shape, device=dev)
    for s in range(samples):
        o, d = primary_rays_from_ij(cam, ii, jj, pid, s, key)
        # the pool: one ray per lane, in lane order, all alive
        pool = {"pix": pid, "lane": lanes, "o": o, "d": d,
                "atten": Vec3.full(shape, 1.0, 1.0, 1.0, device=dev),
                "rad": Vec3.zeros(shape, device=dev),
                "banked": torch.zeros(shape, dtype=torch.bool, device=dev)}
        n_alive = shape[0]
        for b in range(max_depth):
            if n_alive == 0:
                break
            live = {k: _head(v, n_alive) for k, v in pool.items()}
            hit, p, sc = shade_hit(scene, live["o"], live["d"], live["pix"],
                                   s, b, key)
            miss = ~hit
            live["rad"] = vec.where(miss, live["atten"] * _sky_color(live["d"]),
                                    live["rad"])
            live["banked"] = live["banked"] | miss
            alive = hit & sc.scattered & (b < max_depth - 1)
            live["o"] = vec.where(alive, p, live["o"])
            live["d"] = vec.where(alive, sc.direction, live["d"])
            live["atten"] = vec.where(alive, live["atten"] * sc.attenuation,
                                      live["atten"])
            # stable pack: the survivors first, then the dead, each in order
            order = torch.cat([torch.nonzero(alive).flatten(),
                               torch.nonzero(~alive).flatten()])
            pool = {k: _cat(_take(v, order), _tail(pool[k], n_alive))
                    for k, v in live.items()}
            n_alive = int(alive.sum())
        # the rays' radiance back to their lanes, added where they missed
        back = torch.empty_like(pool["lane"])
        back[pool["lane"]] = lanes
        rad, banked = _take(pool["rad"], back), pool["banked"][back]
        acc = vec.where(banked, acc + rad, acc)
    return acc.stack(0)


def _head(v, n):
    return Vec3(*(c[:n] for c in v)) if isinstance(v, Vec3) else v[:n]


def _tail(v, n):
    return Vec3(*(c[n:] for c in v)) if isinstance(v, Vec3) else v[n:]


def _take(v, idx):
    return Vec3(*(c[idx] for c in v)) if isinstance(v, Vec3) else v[idx]


def _cat(a, b):
    if isinstance(a, Vec3):
        return Vec3(*(torch.cat([x, y]) for x, y in zip(a, b)))
    return torch.cat([a, b])


_C_ARGTYPES = [
    ctypes.c_void_p,   # ids (int32)
    ctypes.c_void_p,   # ii
    ctypes.c_void_p,   # jj
    ctypes.c_void_p,   # scene, SoA (11, N)
    ctypes.c_int,      # N
    ctypes.c_void_p,   # cam row
    ctypes.c_void_p,   # out (3, padded)
    ctypes.c_int,      # padded
    ctypes.c_int,      # samples
    ctypes.c_int,      # max_depth
    ctypes.c_uint32,   # key word 0
    ctypes.c_uint32,   # key word 1
    ctypes.c_int,      # fused finalize
    ctypes.c_float,    # finalize scale
    ctypes.c_int,      # hbm layout
    ctypes.c_void_p,   # group table (null: the one-level scan)
    ctypes.c_void_p,   # cudaStream_t
]


@trace.spanned("rt.launch.compact_render")
def compact_kernel(ids, ii, jj, scene_mat, cam_row, *, samples: int,
                   max_depth: int, seed: int = rtrng.DEFAULT_SEED,
                   finalize_scale: Optional[float] = None,
                   layout: str = "vmem") -> torch.Tensor:
    """Launch the CUDA compact kernel; same contract as
    ``compact_reference``. Launches on the current stream without
    synchronising; scans as kernel 1 does (``group_scan``)."""
    if ids.device.type != "cuda":
        raise ValueError(f"compact_kernel takes CUDA tensors, got {ids.device}")
    _check(ids, ii, jj, scene_mat, cam_row, samples=samples,
           max_depth=max_depth, layout=layout)
    from . import _build

    launch = _build.function("compact_render", _C_ARGTYPES)
    padded, n = ids.shape[0], scene_mat.shape[0]
    soa = scene_mat[:, :rk.USED_COLS].t().contiguous()
    out = torch.empty((3, padded), dtype=torch.float32, device=ids.device)
    k0, k1 = rtrng.key_from_seed(seed)
    groups = group_scan.group_table(soa, cam_row, layout)
    err = launch(ids.data_ptr(), ii.data_ptr(), jj.data_ptr(), soa.data_ptr(),
                 n, cam_row.data_ptr(), out.data_ptr(), padded, samples,
                 max_depth, k0, k1, int(finalize_scale is not None),
                 0.0 if finalize_scale is None else finalize_scale,
                 int(layout == "hbm"), group_scan.pointer(groups),
                 torch.cuda.current_stream(ids.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compact_render launch failed: CUDA error {err}")
    trace.count("launch.compact_render")
    group_scan.count_path(groups)
    return out


def _compact(ids, *args, **kw) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if ids.device.type == "cuda":
        return compact_kernel(ids, *args, **kw)
    if ids.device.type == "cpu":
        return compact_reference(ids, *args, **kw)
    raise ValueError(f"no compact implementation for device {ids.device}")
