"""Gradients and the fused train step through the CUDA train kernels.

The counterpart of ``raytracingincuda_tpu/ops/pallas_backward.py``:
``render_kernel_grads`` (``render_pallas_grads`` :1914), ``fused_train``
(``mse_train_pallas`` :2206), ``make_mse_train`` :2744,
``make_tiled_train`` :2634, ``mse_train_tiled`` (``mse_train_pallas_tiled``
:2725) and ``chain_to_params`` :2798.

Two kernels (``csrc/train_render.cu``), each with its plain PyTorch
version beside it, and one signature per pair:

  * kernel A, the gradient kernel: scene and camera cotangents for an
    upstream cotangent ``g`` in the accumulated-radiance domain
    (``grad_kernel`` / ``grad_reference``). It replaces
    ``_grad_tile_kernel_hbm`` and its two other schedules.
  * kernel B, the fused step: the regen render of every lane's pixel,
    the per-pixel loss and its cotangent, then kernel A's reverse with
    that cotangent (``fused_train_kernel`` / ``fused_train_reference``).
    It replaces ``_fused_tile_kernel`` (``park='hbm'``).

``_grad`` and ``_fused`` pick the kernel for CUDA tensors and the plain
version for CPU tensors; neither falls back to the other.

The TPU kernels' schedule knobs (``ray_tile``, ``bwd_ray_tile``,
``sweep``, ``window``, ``park_residuals``, ``park``, ``pixels_per_lane``)
fitted VMEM and the 128-lane rows; the entry points here accept them and
ignore them. ``mesh`` (multiple devices, ROADMAP queue 1 item 6) and
``dtype=float64`` (queue 1 item 4) raise; so does ``layout='packed'``,
the streamed-scene layout, which ``grad.make_stream_train`` trains
(``ops/stream_train_kernel.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..models.camera import (CameraConfig, config_from_leaves, config_leaves,
                             initialize)
from ..models.scene import Scene, param_leaves, params_from_leaves
from . import render_kernel as rk
from . import rng as rtrng
from .backward import (N_CAM, bounce_draws, hit_winner, primary_ray_vjp,
                       winner_bounce, winner_bounce_vjp)
from .tracer import _linear_to_gamma, primary_ray_draws, primary_rays_from_ij
from .vec import Vec3

# The CUDA kernels keep each sample's path in a per-thread stack of this
# many bounces (at least the JAX north star's 50); a deeper max_depth
# raises, it is never truncated.
MAX_DEPTH = 64
LOSSES = ("mse", "l1", "huber", "relmse")
# scene-matrix columns that carry gradients (centre, radius, albedo,
# fuzz, ior); mat/active and the spare columns get zeros
GRAD_COLS = 9
# rows summed per thread in each pass of the fixed-order block reduction
_REDUCE_CHUNK = 64

# Launches of the CUDA train kernels (the wrappers add one per launch).
GRAD_LAUNCHES = 0
FUSED_LAUNCHES = 0


def refuse_unported(mesh=None, dtype=torch.float32,
                    layout: str = "vmem") -> None:
    """Raise for the axes a later slice ports, and for ``layout='packed'``,
    which the stream path trains."""
    if layout == "packed":
        raise ValueError(
            "layout='packed' is the streamed-scene layout; train it with "
            "grad.make_stream_train")
    if mesh is not None:
        raise NotImplementedError(
            "mesh is not ported yet (multiple devices, ROADMAP queue 1 "
            "item 6)")
    if dtype in (torch.float64, "float64", np.float64):
        raise NotImplementedError(
            "dtype=float64 is not ported yet (the kernels instantiated in "
            "double, ROADMAP queue 1 item 4)")
    if dtype not in (torch.float32, "float32", np.float32):
        raise ValueError(f"dtype must be float32, got {dtype!r}")


def _check(ids, ii, jj, rows, scene_mat, cam_row, *, samples, max_depth,
           rr_start, sample_offset, layout):
    if max_depth > MAX_DEPTH:
        raise ValueError(
            f"max_depth {max_depth} exceeds the train kernels' residual "
            f"stack ({MAX_DEPTH} bounces)")
    return rk._check_args(ids, ii, jj, rows, scene_mat, cam_row,
                          samples=samples, max_depth=max_depth,
                          rr_start=rr_start, sample_offset=sample_offset,
                          layout=layout)


def _f32(x: float) -> float:
    """A python float rounded to f32, as JAX rounds a weak constant."""
    return float(np.float32(x))


# -- kernel A: plain version --------------------------------------------------

def grad_reference(ids, ii, jj, g_rows, scene_mat, cam_row, *, samples: int,
                   max_depth: int, seed: int = rtrng.DEFAULT_SEED,
                   rr_start=None, sample_offset: int = 0,
                   layout: str = "vmem"):
    """Plain PyTorch version of kernel A.

    Lane ``i`` traces pixel ``ids[i]`` (column ``ii[i]``, row ``jj[i]``)
    over samples ``[sample_offset, sample_offset + samples)``; ``g_rows``
    (3, padded) is the cotangent of the lane's radiance SUM. Per sample
    the forward scans every slot each bounce (``trace_sample``'s
    recurrence, detached) and keeps each bounce's winner; the reverse
    walks those residuals backwards through ``winner_bounce_vjp`` and the
    primary ray's adjoint. Returns (d_scene_mat (N, 16), d_cam_row (1,
    24)); columns 9-15 and 18-23 are zero. ``layout`` only changes where
    the kernel keeps the scene."""
    rr_start = _check(ids, ii, jj, g_rows, scene_mat, cam_row,
                      samples=samples, max_depth=max_depth, rr_start=rr_start,
                      sample_offset=sample_offset, layout=layout)
    n = scene_mat.shape[0]
    dev = ids.device
    d9 = torch.zeros((n, GRAD_COLS), dtype=torch.float32, device=dev)
    dcam = torch.zeros(N_CAM, dtype=torch.float32, device=dev)
    chunk = max(rk.PAD, rk._REFERENCE_CHUNK_ELEMS // n // rk.PAD * rk.PAD)
    scene = rk.scene_from_matrix(scene_mat)
    cam = rk.unpack_camera(cam_row)
    key = rtrng.key_from_seed(seed)
    for lanes in zip(ids.split(chunk), ii.split(chunk), jj.split(chunk),
                     g_rows.split(chunk, dim=1)):
        _grad_lanes(*lanes, scene, cam, key, d9, dcam, samples=samples,
                    max_depth=max_depth, rr_start=rr_start,
                    sample_offset=sample_offset)
    return _outputs(d9, dcam)


def _outputs(d9, dcam):
    d_scene = torch.zeros((d9.shape[0], rk.NUM_COLS), dtype=torch.float32,
                          device=d9.device)
    d_scene[:, :GRAD_COLS] = d9
    d_cam = torch.zeros((1, 24), dtype=torch.float32, device=d9.device)
    d_cam[0, :N_CAM] = dcam
    return d_scene, d_cam


def _grad_lanes(ids, fi, fj, rows, scene, cam, key, d9, dcam, *, samples,
                max_depth, rr_start, sample_offset, hit_fn=None, record=None):
    """Kernel A's recurrence over one chunk of lanes, adding into ``d9``
    and ``dcam``. ``hit_fn(o, d, alive) -> HitResult`` replaces the
    all-slot scan (the stream walk). ``record(sample - sample_offset,
    bounce, slot, rows9)`` replaces the add into ``d9``: it receives each
    reverse step's nine cotangents and the winning slot, -1 where the
    lane has no record (no winner, or a path that banked no radiance)."""
    pid = ids.to(torch.int64)
    g = Vec3(rows[0], rows[1], rows[2])
    shape, dev = pid.shape, pid.device
    zero3 = Vec3.zeros(shape, device=dev)
    rr = rr_start is not None
    for s in range(sample_offset, sample_offset + samples):
        cam_draws = primary_ray_draws(pid, s, key)
        o, d = primary_rays_from_ij(cam, fi, fj, pid, s, key)
        atten = Vec3.full(shape, 1.0, 1.0, 1.0, device=dev)
        alive = torch.ones(shape, dtype=torch.bool, device=dev)
        parked = []
        banked = torch.zeros(shape, dtype=torch.bool, device=dev)
        for b in range(max_depth):
            if not bool(alive.any()):
                break
            w = hit_winner(scene, o, d,
                           None if hit_fn is None else hit_fn(o, d, alive))
            banked = banked | (alive & ~w.hit)
            draws = bounce_draws(pid, s, b, key, rr)
            parked.append((b, w, o, d, atten, alive, draws))
            (o, d, atten, alive), _ = winner_bounce(
                w.center, w.radius, w.albedo, w.fuzz, w.ior, w.mat, w.hit,
                o, d, atten, alive, bounce=b, rr_start=rr_start, draws=draws)
        # a path that ends (miss, absorption, RR, the depth cap) passes
        # nothing back from beyond its end
        ct_o = ct_d = ct_at = zero3
        for b, w, o, d, atten, alive, draws in reversed(parked):
            ct = winner_bounce_vjp(
                w.center, w.radius, w.albedo, w.fuzz, w.ior, w.mat, w.hit,
                o, d, atten, alive, ct_o, ct_d, ct_at, g, bounce=b,
                rr_start=rr_start, draws=draws)
            valid = w.hit & alive
            rows9 = torch.stack([*ct.wc, ct.wr, *ct.walb, ct.wfuzz, ct.wior],
                                dim=1)
            if record is None:
                d9.index_add_(0, w.sid[valid], rows9[valid])
            else:
                record(s - sample_offset, b,
                       torch.where(valid & banked, w.sid, -1), rows9)
            ct_o, ct_d, ct_at = ct.o, ct.d, ct.atten
        dcam += primary_ray_vjp(cam.use_defocus, fi, fj, cam_draws, ct_o,
                                ct_d).sum(dim=1)


# -- kernel B: plain version --------------------------------------------------

def loss_constants(samples: int, num_pixels: int, huber_delta: float) -> dict:
    """The f32 constants of the loss block, rounded as JAX rounds them."""
    w = 1.0 / (num_pixels * 3)
    hd = float(huber_delta)
    return dict(inv_spp=_f32(1.0 / samples), w=_f32(w), two_w=_f32(2.0 * w),
                hd=_f32(hd), half_hd=_f32(0.5 * hd))


def loss_and_cotangent(acc, target_rows, ids, *, samples: int, gamma: bool,
                       loss: str, huber_delta: float, num_pixels: int):
    """The pointwise block of the fused step (JAX ``_fused_tile_kernel``
    :1673-1733) on (3, padded) lane rows: the image (1/spp, then gamma),
    each lane's loss term (before the 1/(3 * num_pixels) weight), and the
    cotangent ``g`` of the lane's radiance sum. Padding lanes (pixel id
    >= num_pixels) give zero."""
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}; one of {LOSSES}")
    k = loss_constants(samples, num_pixels, huber_delta)
    lin = acc * k["inv_spp"]
    img = _linear_to_gamma(lin) if gamma else lin
    valid = (ids < num_pixels)[None, :]
    diff = torch.where(valid, img - target_rows, torch.zeros_like(img))
    sq = diff * diff
    if loss == "mse":
        per = sq
        g = diff * k["two_w"]
    elif loss == "l1":
        per = diff.abs()
        g = torch.sign(diff) * k["w"]
    elif loss == "huber":
        a = diff.abs()
        per = torch.where(a <= k["hd"], 0.5 * diff * diff,
                          k["hd"] * (a - k["half_hd"]))
        g = torch.minimum(torch.maximum(diff, torch.tensor(-k["hd"])),
                          torch.tensor(k["hd"])) * k["w"]
    else:
        den = target_rows * target_rows + _f32(1e-2)
        per = sq / den
        g = (diff * k["two_w"]) / den
    terms = (per[0] + per[1]) + per[2]
    if gamma:
        pos = img > 0
        g = torch.where(pos, (0.5 * g) / torch.where(pos, img, 1.0),
                        torch.zeros_like(g))
    return img, terms, g * k["inv_spp"]


def fused_train_reference(ids, ii, jj, target_rows, scene_mat, cam_row, *,
                          samples: int, max_depth: int, num_pixels: int,
                          seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                          gamma: bool = True, loss: str = "mse",
                          huber_delta: float = 1.0, layout: str = "vmem"):
    """Plain PyTorch version of kernel B: ``regen_reference``'s render,
    the pointwise loss block, then ``grad_reference`` with that
    cotangent. Returns (loss sum before the weight (), image (3, padded),
    d_scene_mat (N, 16), d_cam_row (1, 24))."""
    _check(ids, ii, jj, target_rows, scene_mat, cam_row, samples=samples,
           max_depth=max_depth, rr_start=rr_start, sample_offset=0,
           layout=layout)
    budget = torch.full(ids.shape, float(samples), dtype=torch.float32,
                        device=ids.device)
    acc = rk.regen_reference(ids, ii, jj, budget, scene_mat, cam_row,
                             samples=samples, max_depth=max_depth, seed=seed,
                             rr_start=rr_start, layout=layout)
    img, terms, g = loss_and_cotangent(acc, target_rows, ids,
                                       samples=samples, gamma=gamma,
                                       loss=loss, huber_delta=huber_delta,
                                       num_pixels=num_pixels)
    d_scene, d_cam = grad_reference(ids, ii, jj, g.contiguous(), scene_mat,
                                    cam_row, samples=samples,
                                    max_depth=max_depth, seed=seed,
                                    rr_start=rr_start, layout=layout)
    return terms.sum(), img, d_scene, d_cam


# -- the CUDA launchers -------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_GRAD_ARGTYPES = [
    _P, _P, _P,     # ids, ii, jj
    _P,             # g rows (3, padded)
    _P, _I,         # scene SoA (11, N), N
    _P, _I,         # cam row, padded
    _I, _I,         # samples, max_depth
    _U, _U,         # key words
    _I, _I, _I,     # sample_offset, rr_start (-1 = off), hbm layout
    _P, _P,         # scene partials (blocks, N * 9), camera partials (blocks, 18)
    _P,             # cudaStream_t
]
_FUSED_ARGTYPES = [
    _P, _P, _P,     # ids, ii, jj
    _P,             # target rows (3, padded)
    _P, _I,         # scene SoA, N
    _P, _I,         # cam row, padded
    _I, _I,         # samples, max_depth
    _U, _U,         # key words
    _I, _I,         # rr_start (-1 = off), hbm layout
    _I, _I, _I,     # gamma, loss kind, num_pixels
    _F, _F, _F, _F, _F,  # inv_spp, w, two_w, hd, half_hd
    _P,             # image (3, padded)
    _P, _P, _P,     # scene, camera and loss partials
    _P,             # cudaStream_t
]
_REDUCE_ARGTYPES = [_P, _I, _I, _I, _P, _P]


def _cuda_only(ids, name):
    if ids.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {ids.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _reduce_rows(partials: torch.Tensor) -> torch.Tensor:
    """Sum a (rows, cols) partials buffer over rows in a fixed order:
    passes of ``_REDUCE_CHUNK``-row groups, each summed in row order, so
    the result is the same bits on every run."""
    from . import _build

    launch = _build.function("reduce_rows", _REDUCE_ARGTYPES)
    x = partials
    while x.shape[0] > 1:
        rows, cols = x.shape
        out = torch.empty((-(-rows // _REDUCE_CHUNK), cols),
                          dtype=torch.float32, device=x.device)
        _raise_on(launch(x.data_ptr(), rows, cols, _REDUCE_CHUNK,
                         out.data_ptr(), _stream(x)), "reduce_rows")
        x = out
    return x[0]


def grad_kernel(ids, ii, jj, g_rows, scene_mat, cam_row, *, samples: int,
                max_depth: int, seed: int = rtrng.DEFAULT_SEED,
                rr_start=None, sample_offset: int = 0,
                layout: str = "vmem"):
    """Launch kernel A; same contract as ``grad_reference``. Launches on
    the current stream without synchronising."""
    global GRAD_LAUNCHES
    _cuda_only(ids, "grad_kernel")
    rr_start = _check(ids, ii, jj, g_rows, scene_mat, cam_row,
                      samples=samples, max_depth=max_depth, rr_start=rr_start,
                      sample_offset=sample_offset, layout=layout)
    from . import _build

    launch = _build.function("grad_render", _GRAD_ARGTYPES)
    padded, n = ids.shape[0], scene_mat.shape[0]
    blocks = padded // rk.PAD
    soa = scene_mat[:, :rk.USED_COLS].t().contiguous()
    scene_part = torch.empty((blocks, n * GRAD_COLS), dtype=torch.float32,
                             device=ids.device)
    cam_part = torch.empty((blocks, N_CAM), dtype=torch.float32,
                           device=ids.device)
    k0, k1 = rtrng.key_from_seed(seed)
    err = launch(ids.data_ptr(), ii.data_ptr(), jj.data_ptr(),
                 g_rows.data_ptr(), soa.data_ptr(), n, cam_row.data_ptr(),
                 padded, samples, max_depth, k0, k1, sample_offset,
                 -1 if rr_start is None else rr_start, int(layout == "hbm"),
                 scene_part.data_ptr(), cam_part.data_ptr(), _stream(ids))
    _raise_on(err, "grad_render")
    GRAD_LAUNCHES += 1
    return _outputs(_reduce_rows(scene_part).view(n, GRAD_COLS),
                    _reduce_rows(cam_part))


def fused_train_kernel(ids, ii, jj, target_rows, scene_mat, cam_row, *,
                       samples: int, max_depth: int, num_pixels: int,
                       seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                       gamma: bool = True, loss: str = "mse",
                       huber_delta: float = 1.0, layout: str = "vmem"):
    """Launch kernel B; same contract as ``fused_train_reference``."""
    global FUSED_LAUNCHES
    _cuda_only(ids, "fused_train_kernel")
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}; one of {LOSSES}")
    rr_start = _check(ids, ii, jj, target_rows, scene_mat, cam_row,
                      samples=samples, max_depth=max_depth, rr_start=rr_start,
                      sample_offset=0, layout=layout)
    from . import _build

    launch = _build.function("fused_train_render", _FUSED_ARGTYPES)
    padded, n = ids.shape[0], scene_mat.shape[0]
    blocks = padded // rk.PAD
    dev = ids.device
    soa = scene_mat[:, :rk.USED_COLS].t().contiguous()
    image = torch.empty((3, padded), dtype=torch.float32, device=dev)
    scene_part = torch.empty((blocks, n * GRAD_COLS), dtype=torch.float32,
                             device=dev)
    cam_part = torch.empty((blocks, N_CAM), dtype=torch.float32, device=dev)
    loss_part = torch.empty((blocks, 1), dtype=torch.float32, device=dev)
    k = loss_constants(samples, num_pixels, huber_delta)
    k0, k1 = rtrng.key_from_seed(seed)
    err = launch(ids.data_ptr(), ii.data_ptr(), jj.data_ptr(),
                 target_rows.data_ptr(), soa.data_ptr(), n,
                 cam_row.data_ptr(), padded, samples, max_depth, k0, k1,
                 -1 if rr_start is None else rr_start, int(layout == "hbm"),
                 int(gamma), LOSSES.index(loss), num_pixels, k["inv_spp"],
                 k["w"], k["two_w"], k["hd"], k["half_hd"], image.data_ptr(),
                 scene_part.data_ptr(), cam_part.data_ptr(),
                 loss_part.data_ptr(), _stream(ids))
    _raise_on(err, "fused_train_render")
    FUSED_LAUNCHES += 1
    d_scene, d_cam = _outputs(_reduce_rows(scene_part).view(n, GRAD_COLS),
                              _reduce_rows(cam_part))
    return _reduce_rows(loss_part)[0], image, d_scene, d_cam


def _grad(ids, *args, **kw):
    """Kernel A for CUDA tensors, its plain version for CPU tensors."""
    if ids.device.type == "cuda":
        return grad_kernel(ids, *args, **kw)
    if ids.device.type == "cpu":
        return grad_reference(ids, *args, **kw)
    raise ValueError(f"no gradient implementation for device {ids.device}")


def _fused(ids, *args, **kw):
    """Kernel B for CUDA tensors, its plain version for CPU tensors."""
    if ids.device.type == "cuda":
        return fused_train_kernel(ids, *args, **kw)
    if ids.device.type == "cpu":
        return fused_train_reference(ids, *args, **kw)
    raise ValueError(f"no fused-step implementation for device {ids.device}")


# -- entry points -------------------------------------------------------------

def _lane_rows(img, ids, num_pixels: int) -> torch.Tensor:
    """(H, W, 3) per-pixel data -> (3, padded) lane rows: lane i carries
    pixel ids[i]'s values, zeros for padding."""
    padded = ids.shape[0]
    flat = torch.as_tensor(img).reshape(num_pixels, 3).to(
        device=ids.device, dtype=torch.float32)
    pad = torch.zeros((padded, 3), dtype=torch.float32, device=ids.device)
    pad[:num_pixels] = flat
    return pad[ids.long()].t().contiguous()


def _packed(scene: Scene, cam_cfg: CameraConfig, img_width, img_height):
    """Detached packed scene matrix and camera row on the scene's device."""
    with torch.no_grad():
        scene_mat = rk.pack_scene_matrix(scene)
        cam_row = rk.pack_camera(initialize(cam_cfg, img_width, img_height))
    return scene_mat, cam_row.to(scene_mat.device)


def render_kernel_grads(scene: Scene, cam_cfg: CameraConfig, g_acc,
                        img_width: int, img_height: int,
                        samples_per_pixel: int, max_depth: int, *,
                        seed: int = rtrng.DEFAULT_SEED, dtype=torch.float32,
                        pixel_order=None, sample_offset: int = 0, mesh=None,
                        rr_start=None, layout: str = "vmem", ray_tile=None,
                        sweep=None, window: int = 0, pixels_per_lane=None,
                        park=None):
    """Cotangents (d_scene_mat (N, 16), d_cam_row (1, 24)) for an
    upstream cotangent ``g_acc`` (H, W, 3) in the ACCUMULATED radiance
    domain (before 1/spp and gamma; ``make_diff_render`` chains those on
    the host). Runs on the scene's device: kernel A on a card, its plain
    version on the CPU.

    ``sample_offset`` selects the sample window: cotangents are sums over
    samples, so calls over disjoint windows add up. ``pixel_order`` (a
    (padded,) permutation) changes speed only. ``ray_tile``, ``sweep``,
    ``window``, ``pixels_per_lane`` and ``park`` shaped the TPU schedule
    and are ignored."""
    refuse_unported(mesh, dtype, layout)
    del ray_tile, sweep, window, pixels_per_lane, park
    scene_mat, cam_row = _packed(scene, cam_cfg, img_width, img_height)
    ids, ii, jj, _ = rk._lane_setup(img_width, img_height, pixel_order,
                                    samples_per_pixel, sample_offset, None,
                                    scene_mat.device)
    rows = _lane_rows(g_acc, ids, img_width * img_height)
    return _grad(ids, ii, jj, rows, scene_mat, cam_row,
                 samples=samples_per_pixel, max_depth=max_depth, seed=seed,
                 rr_start=rr_start, sample_offset=sample_offset,
                 layout=layout)


def fused_train(scene: Scene, cam_cfg: CameraConfig, target,
                img_width: int, img_height: int, samples_per_pixel: int,
                max_depth: int, *, seed: int = rtrng.DEFAULT_SEED,
                dtype=torch.float32, gamma: bool = True, pixel_order=None,
                mesh=None, rr_start=None, tile_chunk=None, loss: str = "mse",
                huber_delta: float = 1.0, layout: str = "vmem",
                ray_tile=None, park_residuals=None, sweep=None,
                window: int = 0, pixels_per_lane=None):
    """Fused per-pixel-loss train step: ``(loss, image, d_scene_mat,
    d_cam_row)`` against a target image (H, W, 3), from one launch of
    kernel B (its plain version on the CPU).

    ``loss`` is 'mse' | 'l1' | 'huber' | 'relmse', each a mean over the
    num_pixels * 3 channels of the image after 1/spp and (``gamma``)
    gamma 2. ``tile_chunk=(start, count)`` runs only lanes
    ``[start * PAD, (start + count) * PAD)``: loss and cotangents come
    back as partial sums with the global normalisation, so chunks add up
    (up to float summation order), and the image as raw (3, count * PAD)
    lane rows; ``make_tiled_train`` drives the chunks. ``ray_tile``,
    ``park_residuals``, ``sweep``, ``window`` and ``pixels_per_lane``
    shaped the TPU schedule and are ignored."""
    refuse_unported(mesh, dtype, layout)
    del ray_tile, park_residuals, sweep, window, pixels_per_lane
    scene_mat, cam_row = _packed(scene, cam_cfg, img_width, img_height)
    num_pixels = img_width * img_height
    ids, ii, jj, _ = rk._lane_setup(img_width, img_height, pixel_order,
                                    samples_per_pixel, 0, None,
                                    scene_mat.device)
    rows = _lane_rows(target, ids, num_pixels)
    if tile_chunk is not None:
        t0, count = (int(v) for v in tile_chunk)
        tiles = ids.shape[0] // rk.PAD
        if count < 1 or t0 < 0 or t0 + count > tiles:
            raise ValueError(f"tile_chunk {tile_chunk} outside the {tiles} "
                             f"tiles of {rk.PAD} lanes")
        sl = slice(t0 * rk.PAD, (t0 + count) * rk.PAD)
        ids, ii, jj = ids[sl], ii[sl], jj[sl]
        rows = rows[:, sl].contiguous()
    total, img, d_scene, d_cam = _fused(
        ids, ii, jj, rows, scene_mat, cam_row, samples=samples_per_pixel,
        max_depth=max_depth, num_pixels=num_pixels, seed=seed,
        rr_start=rr_start, gamma=gamma, loss=loss, huber_delta=huber_delta,
        layout=layout)
    loss_v = total * loss_constants(samples_per_pixel, num_pixels,
                                    huber_delta)["w"]
    if tile_chunk is not None:
        return loss_v, img, d_scene, d_cam
    return (loss_v, rk._finalize_output(img, ids, pixel_order is not None,
                                        img_width, img_height,
                                        samples_per_pixel, gamma,
                                        accumulate_only=True,
                                        already_finalized=True),
            d_scene, d_cam)


def make_tiled_train(scene: Scene, cam_cfg: CameraConfig, img_width: int,
                     img_height: int, samples_per_pixel: int, max_depth: int,
                     *, n_chunks: int, pixel_order=None,
                     seed: int = rtrng.DEFAULT_SEED, gamma: bool = True,
                     rr_start=None, dtype=torch.float32, loss: str = "mse",
                     huber_delta: float = 1.0, layout: str = "vmem",
                     ray_tile=None, pixels_per_lane=None,
                     park_residuals=None):
    """The fused step in ``n_chunks`` tile ranges; returns ``step(target)
    -> (loss, image, d_scene_mat, d_cam_row)``, the sums of the chunks'
    partial sums and the reassembled image. ``ray_tile``,
    ``pixels_per_lane`` and ``park_residuals`` are ignored."""
    refuse_unported(None, dtype, layout)
    num_pixels = img_width * img_height
    tiles = rk._round_up(num_pixels, rk.PAD) // rk.PAD
    bounds = [(tiles * c // n_chunks, tiles * (c + 1) // n_chunks)
              for c in range(n_chunks)]
    bounds = [(t0, t1 - t0) for t0, t1 in bounds if t1 > t0]
    kw = dict(seed=seed, gamma=gamma, pixel_order=pixel_order,
              rr_start=rr_start, loss=loss, huber_delta=huber_delta,
              layout=layout)

    def step(target):
        loss_v = d_sm = d_cr = None
        rows = []
        for chunk in bounds:
            lo, im, dsm, dcr = fused_train(
                scene, cam_cfg, target, img_width, img_height,
                samples_per_pixel, max_depth, tile_chunk=chunk, **kw)
            loss_v = lo if loss_v is None else loss_v + lo
            d_sm = dsm if d_sm is None else d_sm + dsm
            d_cr = dcr if d_cr is None else d_cr + dcr
            rows.append(im)
        ids = (torch.arange(tiles * rk.PAD, dtype=torch.int32)
               if pixel_order is None else torch.as_tensor(pixel_order))
        img = rk._finalize_output(torch.cat(rows, dim=1),
                                  ids.to(rows[0].device),
                                  pixel_order is not None, img_width,
                                  img_height, samples_per_pixel, gamma,
                                  accumulate_only=True,
                                  already_finalized=True)
        return loss_v, img, d_sm, d_cr

    return step


def mse_train_tiled(scene: Scene, cam_cfg: CameraConfig, target,
                    img_width: int, img_height: int, samples_per_pixel: int,
                    max_depth: int, **kw):
    """One-shot ``make_tiled_train``."""
    return make_tiled_train(scene, cam_cfg, img_width, img_height,
                            samples_per_pixel, max_depth, **kw)(target)


def make_mse_train(mat_type, active, img_width: int, img_height: int,
                   samples_per_pixel: int, max_depth: int, *,
                   seed: int = rtrng.DEFAULT_SEED, gamma: bool = True,
                   pixel_order=None, mesh=None, rr_start=None,
                   loss: str = "mse", huber_delta: float = 1.0,
                   layout: str = "vmem", ray_tile=None, park_residuals=None,
                   sweep=None, window: int = 0, pixels_per_lane=None):
    """The fused train step builder: ``f(params, cam_cfg, target) ->
    (loss, image, (d_params, d_cam_cfg))``. ``pixel_order`` (e.g. a
    frozen difficulty order) changes speed only. ``ray_tile``,
    ``park_residuals``, ``sweep``, ``window`` and ``pixels_per_lane`` are
    ignored."""
    refuse_unported(mesh, layout=layout)
    del ray_tile, park_residuals, sweep, window, pixels_per_lane

    def f(params, cam_cfg, target):
        scene = Scene(params=params, mat_type=mat_type, active=active)
        loss_v, img, d_sm, d_cr = fused_train(
            scene, cam_cfg, target, img_width, img_height, samples_per_pixel,
            max_depth, seed=seed, gamma=gamma, pixel_order=pixel_order,
            rr_start=rr_start, loss=loss, huber_delta=huber_delta,
            layout=layout)
        grads = chain_to_params(d_sm, d_cr, params, cam_cfg, mat_type,
                                active, img_width, img_height)
        return loss_v, img, grads

    return f


def chain_to_params(d_scene_mat, d_cam_row, params, cam_cfg, mat_type,
                    active, img_width: int, img_height: int):
    """Packed-matrix and camera-row cotangents -> (SceneParams,
    CameraConfig) cotangents: autograd through ``pack_scene_matrix`` and
    ``pack_camera(initialize(...))``."""
    p_leaves = [t.detach().requires_grad_(True) for t in param_leaves(params)]
    c_leaves = [t.detach().requires_grad_(True)
                for t in config_leaves(cam_cfg)]
    with torch.enable_grad():
        m = rk.pack_scene_matrix(Scene(params_from_leaves(p_leaves),
                                       mat_type, active))
        row = rk.pack_camera(initialize(config_from_leaves(c_leaves),
                                        img_width, img_height))
        dp = torch.autograd.grad(m, p_leaves, d_scene_mat.to(m.device),
                                 allow_unused=True)
        dc = torch.autograd.grad(row, c_leaves, d_cam_row.to(row.device),
                                 allow_unused=True)
    fill = lambda gs, ls: [torch.zeros_like(l) if g is None else g  # noqa: E731
                           for g, l in zip(gs, ls)]
    return (params_from_leaves(fill(dp, p_leaves)),
            config_from_leaves(fill(dc, c_leaves)))
