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

Kernel B is two launches per window of lanes: the park render (the
render at the regen kernel's resources, parking each sample's winning
slots) and the reverse (``reverse_render``), which rebuilds each parked
sample from its slots and re-traces the samples that did not fit.
Kernel A is that reverse with nothing parked. ``plan_park`` picks the
park's capacity (entries a lane) and the windows, so that the park stays
within ``PARK_BUDGET``; a sample's cotangents enter the sums in the same
order whether it was parked or re-traced, so the gradients are the same
bits at any capacity and window. ``capacity``, ``budget`` and ``acc``
are for tests, not a user's knobs.

``_grad`` and ``_fused`` (``kernel_io.by_device``) pick the kernel for
CUDA tensors and the plain version for CPU tensors; neither falls back to
the other. The formats, the launch and the fixed-order sum of the block
partials (``reduce_rows``) are ``ops/kernel_io.py``'s.

The TPU kernels' schedule knobs (``ray_tile``, ``bwd_ray_tile``,
``sweep``, ``window``, ``park_residuals``, ``park``, ``pixels_per_lane``)
fitted VMEM and the 128-lane rows; the entry points here accept them and
ignore them. ``dtype=float64`` raises: as in JAX, double precision has
gradients through the oracle only (``grad.make_loss_fn(impl='oracle',
dtype=torch.float64)``). So does ``layout='packed'``, the streamed-scene
layout, which ``grad.make_stream_train`` trains
(``ops/stream_train_kernel.py``). ``mesh=`` (``parallel/mesh.py``) gives
each rank its slice of the lanes; the loss constants use the global
pixel count on every rank, and a step's loss and cotangents are summed
over the ranks by one ``all_reduce`` of one flat buffer.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.camera import (CameraConfig, config_from_leaves, config_leaves,
                             initialize)
from ..models.scene import Scene, round_up
from ..parallel import mesh as meshlib
from ..utils import trace
from . import group_scan
from . import kernel_io as kio
from . import render_kernel as rk
from . import rng as rtrng
from .kernel_io import GRAD_COLS, PAD
from .backward import (N_CAM, bounce_draws, hit_winner, primary_ray_vjp,
                       winner_bounce, winner_bounce_vjp)
from .tracer import linear_to_gamma, primary_ray_draws, primary_rays_from_ij
from .vec import Vec3

# The deepest path the train kernels take: the sampler's bounce field
# (rng.MAX_BOUNCE, 256), as in JAX, whose validate_stream_ids raises above
# it. The reverse keeps a sample's path in a per-thread stack; it is built
# twice (csrc/train_render.cu), for STACK_SHALLOW bounces (the main paths'
# depths, the north star's 50 among them) and for MAX_DEPTH, and a launch
# takes the smaller instance that holds max_depth.
MAX_DEPTH = rtrng.MAX_BOUNCE
STACK_SHALLOW = 64
LOSSES = ("mse", "l1", "huber", "relmse")
# The fused step's park: at most this many bytes at once (the park and,
# where the warps' accumulators live in device memory, theirs), and at
# least this many entries a lane per sample unless the budget forbids it.
# At the headline (1280x768, 100 spp, rr2) a lane parks 193 entries on
# average and 482 at most (PERF.md §6), so the whole image parks in one
# window.
PARK_BUDGET = 2 << 30
PARK_ENTRIES_PER_SAMPLE = 4
_PARK_ENTRY_BYTES = 4
# The reverse runs 4 blocks an SM (128 registers a thread). Its four
# warps' (N, 9) accumulators go to shared memory, beside the staged scene
# and the staging columns (csrc/train_render.cu: kReverseStatic,
# stage_scene's 44 bytes a slot), only where that keeps those 4 blocks:
# at most a quarter of the SM's 228 KB less the 1 KB it reserves a block
# (about 270 slots, layout vmem). Else they live in device memory, which
# at scene 1's 512 slots measured faster (PERF.md §6).
_MAX_SMEM = 232448
_SMEM_PER_SM = 233472
_REVERSE_BLOCKS_PER_SM = 4
_WARPS = 4
_REVERSE_STATIC_SMEM = 4 * GRAD_COLS * 128
_STAGE_BYTES_PER_SLOT = 44

# The wrappers count their launches (utils/trace.py): launch.grad_render
# one reverse a window of kernel A, launch.fused_train_render a park render
# and a reverse a window of kernel B (one window unless the park's budget
# needs more).


def refuse_unported(dtype=torch.float32, layout: str = "vmem") -> None:
    """Raise for what the f32 kernels do not take: ``dtype=float64``,
    which has gradients through the oracle only, and ``layout='packed'``,
    which the stream path trains."""
    if layout == "packed":
        raise ValueError(
            "layout='packed' is the streamed-scene layout; train it with "
            "grad.make_stream_train")
    if dtype in (torch.float64, "float64", np.float64):
        raise NotImplementedError(
            "dtype=float64 has no gradient kernel: as in JAX, double "
            "precision differentiates through the oracle only; use "
            "impl='oracle' (grad.make_loss_fn / make_train_step with "
            "dtype=torch.float64)")
    if dtype not in (torch.float32, "float32", np.float32):
        raise ValueError(f"dtype must be float32, got {dtype!r}")


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
    rr_start = kio.check(ids, ii, jj, scene_mat, cam_row, rows=g_rows,
                         samples=samples, max_depth=max_depth,
                         rr_start=rr_start, sample_offset=sample_offset,
                         layout=layout)
    n = scene_mat.shape[0]
    dev = ids.device
    d9 = torch.zeros((n, GRAD_COLS), dtype=torch.float32, device=dev)
    dcam = torch.zeros(N_CAM, dtype=torch.float32, device=dev)
    chunk = kio.reference_chunk(n)
    scene = kio.scene_from_matrix(scene_mat)
    cam = kio.unpack_camera(cam_row)
    key = rtrng.key_from_seed(seed)
    for lanes in zip(ids.split(chunk), ii.split(chunk), jj.split(chunk),
                     g_rows.split(chunk, dim=1)):
        grad_lanes(*lanes, scene, cam, key, d9, dcam, samples=samples,
                   max_depth=max_depth, rr_start=rr_start,
                   sample_offset=sample_offset)
    return kio.grad_outputs(d9, dcam)


def path_ends(ids, ii, jj, scene_mat, cam_row, *, samples: int,
              max_depth: int, seed: int = rtrng.DEFAULT_SEED, rr_start=None,
              layout: str = "vmem") -> torch.Tensor:
    """Where each sample's path banked its radiance, from kernel A's plain
    version: (samples, padded) int64, the bounce at which the path missed
    (its reverse runs that many steps), or 0 where it has nothing to pass
    back (it ended black, or its primary ray missed)."""
    rows = torch.ones((3, ids.shape[0]), device=ids.device)
    rr_start = kio.check(ids, ii, jj, scene_mat, cam_row, rows=rows,
                         samples=samples, max_depth=max_depth,
                         rr_start=rr_start, layout=layout)
    ends = torch.zeros((samples, ids.shape[0]), dtype=torch.int64,
                       device=ids.device)

    def record(si, b, slot, rows9):
        ends[si] = torch.where((slot >= 0) & (ends[si] == 0), b + 1, ends[si])

    grad_lanes(ids, ii, jj, rows, kio.scene_from_matrix(scene_mat),
               kio.unpack_camera(cam_row), rtrng.key_from_seed(seed), None,
               torch.zeros(N_CAM, device=ids.device), samples=samples,
               max_depth=max_depth, rr_start=rr_start, sample_offset=0,
               record=record)
    return ends


def grad_lanes(ids, fi, fj, rows, scene, cam, key, d9, dcam, *, samples,
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
    img = linear_to_gamma(lin) if gamma else lin
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
    kio.check(ids, ii, jj, scene_mat, cam_row, rows=target_rows,
              samples=samples, max_depth=max_depth, rr_start=rr_start,
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
_PARK_ARGTYPES = [
    _P, _P, _P,     # ids, ii, jj (at the window's first lane)
    _P, _I,         # target rows (3, padded), row stride
    _P, _I,         # scene SoA (11, N), N
    _P, _I,         # cam row, the window's lanes
    _I, _I,         # samples, max_depth
    _U, _U,         # key words
    _I, _I,         # rr_start (-1 = off), hbm layout
    _I, _I, _I,     # gamma, loss kind, num_pixels
    _F, _F, _F, _F, _F,  # inv_spp, w, two_w, hd, half_hd
    _P, _P, _P,     # image, g (3, padded), loss partials (blocks, 1)
    _P, _I,         # park (capacity, window lanes) int32, capacity
    _P,             # parked (2, padded) int32
    _P,             # group table (null: the one-level scan)
]
_REVERSE_ARGTYPES = [
    _P, _P, _P,     # ids, ii, jj (at the window's first lane)
    _P, _I,         # g rows (3, padded), row stride
    _P, _I,         # scene SoA, N
    _P, _I,         # cam row, the window's lanes
    _I, _I,         # samples, max_depth
    _U, _U,         # key words
    _I, _I, _I,     # sample_offset, rr_start (-1 = off), hbm layout
    _I,             # stack instance (0: the smaller that holds max_depth)
    _P, _P,         # park, parked (null: nothing parked)
    _P,             # the warps' accumulators (null: shared memory)
    _P, _P,         # scene partials (blocks, N * 9), camera partials (blocks, 18)
]


class ParkPlan(NamedTuple):
    """The fused step's park: ``capacity`` entries a lane, the reverse's
    warp accumulators in shared memory (``acc_in_smem``) or in device
    memory, and the windows as (first lane, lanes)."""
    capacity: int
    acc_in_smem: bool
    windows: list


def _acc_smem_bytes(n: int, layout: str) -> int:
    """A reverse block's shared memory with its warps' accumulators there."""
    stage = 0 if layout == "hbm" else n * _STAGE_BYTES_PER_SLOT
    return stage + _WARPS * n * GRAD_COLS * 4 + _REVERSE_STATIC_SMEM


def plan_park(lanes: int, samples: int, max_depth: int, n: int,
              layout: str = "vmem", *, capacity: Optional[int] = None,
              budget: int = PARK_BUDGET, acc: Optional[str] = None) -> ParkPlan:
    """Capacity and windows for ``lanes`` lanes (a multiple of ``PAD``) of
    kernel B, or of kernel A with ``capacity=0``.

    Every lane falls in exactly one window, each a multiple of ``PAD``
    lanes, and one window's park (``capacity`` int32 entries a lane) and,
    where the reverse's four warp accumulators do not fit in shared memory
    (or ``acc='device'``), its device-memory accumulators (N * 36 bytes a
    warp) take at most ``budget`` bytes. By default the capacity is what
    one window of all lanes allows, at least ``PARK_ENTRIES_PER_SAMPLE`` a
    sample (windows, if the budget needs them) and at most ``samples *
    max_depth`` (no sample parks more than ``max_depth`` entries)."""
    if lanes <= 0 or lanes % PAD:
        raise ValueError(f"lanes must be a positive multiple of {PAD}")
    if acc not in (None, "shared", "device"):
        raise ValueError(f"acc must be None, 'shared' or 'device', got {acc!r}")
    smem = _acc_smem_bytes(n, layout)
    if acc is None:
        in_smem = smem <= _SMEM_PER_SM // _REVERSE_BLOCKS_PER_SM - 1024
    else:
        in_smem = acc == "shared"
    if in_smem and smem > _MAX_SMEM:
        raise ValueError(f"{n} slots' warp accumulators do not fit in shared "
                         f"memory")
    scratch = 0 if in_smem else _WARPS * n * GRAD_COLS * 4  # bytes a block
    blocks = lanes // PAD
    per_entry = PAD * _PARK_ENTRY_BYTES                     # bytes a block
    if capacity is None:
        one_window = (budget // blocks - scratch) // per_entry
        capacity = min(samples * max_depth,
                       max(PARK_ENTRIES_PER_SAMPLE * samples, one_window))
        capacity = max(0, min(capacity, (budget - scratch) // per_entry))
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    block_bytes = capacity * per_entry + scratch
    if block_bytes > budget:
        raise ValueError(f"one block of {PAD} lanes needs {block_bytes} "
                         f"bytes, above the budget of {budget}")
    per = min(blocks, budget // block_bytes) if block_bytes else blocks
    windows = [(b * PAD, min(per, blocks - b) * PAD)
               for b in range(0, blocks, per)]
    return ParkPlan(int(capacity), in_smem, windows)


@trace.spanned("rt.launch.reverse")
def _reverse(launch, ids, ii, jj, g_rows, soa, cam_row, window, *, samples,
             max_depth, key, sample_offset, rr_start, layout, stack, park,
             parked, warp_acc, scene_part, cam_part):
    """One ``launch`` of the reverse over one window of lanes; its
    re-traced samples scan in one level."""
    at = kio.at
    w0, lanes = window
    launch(at(ids, col=w0), at(ii, col=w0), at(jj, col=w0),
           at(g_rows, col=w0), g_rows.shape[1], soa.data_ptr(), soa.shape[1],
           cam_row.data_ptr(), lanes, samples, max_depth, *key,
           sample_offset, -1 if rr_start is None else rr_start,
           int(layout == "hbm"), stack or 0, at(park), at(parked, col=w0),
           at(warp_acc), at(scene_part, w0 // PAD), at(cam_part, w0 // PAD))
    group_scan.count_path(None)


def _warp_acc(plan: ParkPlan, n: int, dev):
    if plan.acc_in_smem:
        return None
    widest = max(c for _, c in plan.windows)
    return torch.empty((widest // 32, n * GRAD_COLS), dtype=torch.float32,
                       device=dev)


@trace.spanned("rt.launch.grad_render")
def grad_kernel(ids, ii, jj, g_rows, scene_mat, cam_row, *, samples: int,
                max_depth: int, seed: int = rtrng.DEFAULT_SEED,
                rr_start=None, sample_offset: int = 0,
                layout: str = "vmem", budget: int = PARK_BUDGET,
                acc: Optional[str] = None, stack: Optional[int] = None):
    """Launch kernel A (the reverse with nothing parked: every sample
    re-traced); same contract as ``grad_reference``. Launches on the
    current stream without synchronising. ``stack`` (STACK_SHALLOW or
    MAX_DEPTH) forces the reverse's instance, for tests and measurements;
    by default the smaller one that holds ``max_depth``."""
    reverse = kio.entry("reverse_render", _REVERSE_ARGTYPES, ids.device)
    rr_start = kio.check(ids, ii, jj, scene_mat, cam_row, rows=g_rows,
                         samples=samples, max_depth=max_depth,
                         rr_start=rr_start, sample_offset=sample_offset,
                         layout=layout)
    padded, n = ids.shape[0], scene_mat.shape[0]
    plan = plan_park(padded, samples, max_depth, n, layout, capacity=0,
                     budget=budget, acc=acc)
    blocks = padded // PAD
    scene_part = torch.empty((blocks, n * GRAD_COLS), dtype=torch.float32,
                             device=ids.device)
    cam_part = torch.empty((blocks, N_CAM), dtype=torch.float32,
                           device=ids.device)
    soa, warp_acc = kio.soa(scene_mat), _warp_acc(plan, n, ids.device)
    g_rows, key = g_rows.contiguous(), rtrng.key_from_seed(seed)
    for window in plan.windows:
        _reverse(reverse, ids, ii, jj, g_rows, soa, cam_row, window,
                 samples=samples, max_depth=max_depth, key=key,
                 sample_offset=sample_offset, rr_start=rr_start,
                 layout=layout, stack=stack, park=None, parked=None,
                 warp_acc=warp_acc, scene_part=scene_part, cam_part=cam_part)
        trace.count("launch.grad_render")
    return kio.grad_outputs(kio.reduce_rows(scene_part).view(n, GRAD_COLS),
                            kio.reduce_rows(cam_part))


class FusedParts(NamedTuple):
    """Kernel B's outputs before the block partials are summed."""
    loss_part: torch.Tensor   # (blocks, 1)
    image: torch.Tensor       # (3, padded)
    g: torch.Tensor           # (3, padded): the cotangent of each radiance sum
    scene_part: torch.Tensor  # (blocks, N * 9)
    cam_part: torch.Tensor    # (blocks, 18)
    parked: torch.Tensor      # (2, padded) int32: samples parked, entries used
    plan: ParkPlan


@trace.spanned("rt.launch.fused_train_render")
def fused_train_parts(ids, ii, jj, target_rows, scene_mat, cam_row, *,
                      samples: int, max_depth: int, num_pixels: int,
                      seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                      gamma: bool = True, loss: str = "mse",
                      huber_delta: float = 1.0, layout: str = "vmem",
                      capacity: Optional[int] = None,
                      budget: int = PARK_BUDGET,
                      acc: Optional[str] = None,
                      stack: Optional[int] = None) -> FusedParts:
    """Kernel B's launches (per window of ``plan_park``: the park render,
    then the reverse), before the block partials are summed; ``stack`` as
    ``grad_kernel``'s."""
    render = kio.entry("fused_park_render", _PARK_ARGTYPES, ids.device)
    reverse = kio.entry("reverse_render", _REVERSE_ARGTYPES, ids.device)
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}; one of {LOSSES}")
    rr_start = kio.check(ids, ii, jj, scene_mat, cam_row, rows=target_rows,
                         samples=samples, max_depth=max_depth,
                         rr_start=rr_start, layout=layout)
    padded, n = ids.shape[0], scene_mat.shape[0]
    plan = plan_park(padded, samples, max_depth, n, layout, capacity=capacity,
                     budget=budget, acc=acc)
    blocks, dev = padded // PAD, ids.device
    f32 = dict(dtype=torch.float32, device=dev)
    image = torch.empty((3, padded), **f32)
    g = torch.empty((3, padded), **f32)
    loss_part = torch.empty((blocks, 1), **f32)
    scene_part = torch.empty((blocks, n * GRAD_COLS), **f32)
    cam_part = torch.empty((blocks, N_CAM), **f32)
    parked = torch.empty((2, padded), dtype=torch.int32, device=dev)
    widest = max(c for _, c in plan.windows)
    park = (torch.empty((plan.capacity * widest,), dtype=torch.int32,
                        device=dev) if plan.capacity else None)
    soa, warp_acc = kio.soa(scene_mat), _warp_acc(plan, n, dev)
    target_rows = target_rows.contiguous()
    k = loss_constants(samples, num_pixels, huber_delta)
    key = rtrng.key_from_seed(seed)
    rr = -1 if rr_start is None else rr_start
    groups = group_scan.group_table(soa, cam_row, layout)
    at = kio.at
    for window in plan.windows:
        w0, lanes = window
        render(at(ids, col=w0), at(ii, col=w0), at(jj, col=w0),
               at(target_rows, col=w0), padded, soa.data_ptr(), n,
               cam_row.data_ptr(), lanes, samples, max_depth, *key, rr,
               int(layout == "hbm"), int(gamma), LOSSES.index(loss),
               num_pixels, k["inv_spp"], k["w"], k["two_w"], k["hd"],
               k["half_hd"], at(image, col=w0), at(g, col=w0),
               at(loss_part, w0 // PAD), at(park), plan.capacity,
               at(parked, col=w0), at(groups))
        group_scan.count_path(groups)
        _reverse(reverse, ids, ii, jj, g, soa, cam_row, window,
                 samples=samples, max_depth=max_depth, key=key,
                 sample_offset=0, rr_start=rr_start, layout=layout,
                 stack=stack, park=park,
                 parked=None if park is None else parked, warp_acc=warp_acc,
                 scene_part=scene_part, cam_part=cam_part)
        trace.count("launch.fused_train_render", 2)
    return FusedParts(loss_part, image, g, scene_part, cam_part, parked, plan)


@trace.spanned("rt.launch.fused_train")
def fused_train_kernel(ids, ii, jj, target_rows, scene_mat, cam_row, *,
                       samples: int, max_depth: int, num_pixels: int,
                       seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                       gamma: bool = True, loss: str = "mse",
                       huber_delta: float = 1.0, layout: str = "vmem",
                       capacity: Optional[int] = None,
                       budget: int = PARK_BUDGET, acc: Optional[str] = None,
                       stack: Optional[int] = None):
    """Launch kernel B; same contract as ``fused_train_reference``."""
    parts = fused_train_parts(
        ids, ii, jj, target_rows, scene_mat, cam_row, samples=samples,
        max_depth=max_depth, num_pixels=num_pixels, seed=seed,
        rr_start=rr_start, gamma=gamma, loss=loss, huber_delta=huber_delta,
        layout=layout, capacity=capacity, budget=budget, acc=acc,
        stack=stack)
    n = scene_mat.shape[0]
    d_scene, d_cam = kio.grad_outputs(
        kio.reduce_rows(parts.scene_part).view(n, GRAD_COLS),
        kio.reduce_rows(parts.cam_part))
    return kio.reduce_rows(parts.loss_part)[0], parts.image, d_scene, d_cam


_grad = kio.by_device(grad_kernel, grad_reference)
_fused = kio.by_device(fused_train_kernel, fused_train_reference)


# -- entry points -------------------------------------------------------------

def _packed(scene: Scene, cam_cfg: CameraConfig, img_width, img_height):
    """Detached packed scene matrix and camera row on the scene's device."""
    with torch.no_grad():
        scene_mat = kio.pack_scene_matrix(scene)
    return scene_mat, kio.camera_row(cam_cfg, img_width, img_height,
                                     scene_mat.device)


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
    and are ignored. ``mesh``: each rank takes its slice of the lanes, and
    the cotangents are summed over the ranks (one ``all_reduce``)."""
    refuse_unported(dtype, layout)
    del ray_tile, sweep, window, pixels_per_lane, park
    scene_mat, cam_row = _packed(scene, cam_cfg, img_width, img_height)
    ids, ii, jj, _ = kio.lane_setup(img_width, img_height, pixel_order,
                                    samples_per_pixel, sample_offset, None,
                                    scene_mat.device, mesh)
    rows = kio.lane_rows(g_acc, ids, img_width * img_height)
    ids, ii, jj, rows = kio.shard(mesh, ids, ii, jj, rows)
    d_scene, d_cam = _grad(ids, ii, jj, rows, scene_mat, cam_row,
                           samples=samples_per_pixel, max_depth=max_depth,
                           seed=seed, rr_start=rr_start,
                           sample_offset=sample_offset, layout=layout)
    return meshlib.all_reduce_sum(mesh, d_scene, d_cam)


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
    shaped the TPU schedule and are ignored.

    ``mesh``: each rank runs kernel B on its slice of the lanes with the
    global loss constants; one ``all_reduce`` of one flat buffer sums the
    loss and the cotangents over the ranks and assembles the image (the
    ranks' pixels are disjoint, so that part of the sum is exact)."""
    refuse_unported(dtype, layout)
    del ray_tile, park_residuals, sweep, window, pixels_per_lane
    if tile_chunk is not None and meshlib.sharded(mesh):
        raise ValueError("tile_chunk runs one process's tile ranges; it "
                         "takes no mesh")
    scene_mat, cam_row = _packed(scene, cam_cfg, img_width, img_height)
    num_pixels = img_width * img_height
    ids, ii, jj, _ = kio.lane_setup(img_width, img_height, pixel_order,
                                    samples_per_pixel, 0, None,
                                    scene_mat.device, mesh)
    rows = kio.lane_rows(target, ids, num_pixels)
    full_ids, padded = ids, ids.shape[0]
    ids, ii, jj, rows = kio.shard(mesh, ids, ii, jj, rows)
    if tile_chunk is not None:
        t0, count = (int(v) for v in tile_chunk)
        tiles = ids.shape[0] // PAD
        if count < 1 or t0 < 0 or t0 + count > tiles:
            raise ValueError(f"tile_chunk {tile_chunk} outside the {tiles} "
                             f"tiles of {PAD} lanes")
        sl = slice(t0 * PAD, (t0 + count) * PAD)
        ids, ii, jj = ids[sl], ii[sl], jj[sl]
        rows = rows[:, sl].contiguous()
    total, img, d_scene, d_cam = _fused(
        ids, ii, jj, rows, scene_mat, cam_row, samples=samples_per_pixel,
        max_depth=max_depth, num_pixels=num_pixels, seed=seed,
        rr_start=rr_start, gamma=gamma, loss=loss, huber_delta=huber_delta,
        layout=layout)
    if meshlib.sharded(mesh):
        full = img.new_zeros((3, padded))
        full[:, meshlib.local_slice(padded, mesh)] = img
        total, d_scene, d_cam, img = meshlib.all_reduce_sum(
            mesh, total, d_scene, d_cam, full)
    loss_v = total * loss_constants(samples_per_pixel, num_pixels,
                                    huber_delta)["w"]
    if tile_chunk is not None:
        return loss_v, img, d_scene, d_cam
    return (loss_v, kio.finalize_output(img, full_ids,
                                        pixel_order is not None,
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
    refuse_unported(dtype, layout)
    num_pixels = img_width * img_height
    tiles = round_up(num_pixels, PAD) // PAD
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
        ids = (torch.arange(tiles * PAD, dtype=torch.int32)
               if pixel_order is None else torch.as_tensor(pixel_order))
        img = kio.finalize_output(torch.cat(rows, dim=1),
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
    (loss, image, (d_params, d_cam_cfg))``, run on the device of
    ``mat_type``, ``active`` and the params (kernel 2 on a card, its plain
    version on the CPU). ``pixel_order`` (e.g. a
    frozen difficulty order) changes speed only. ``mesh``: as
    ``fused_train``, one ``all_reduce`` a step. ``ray_tile``,
    ``park_residuals``, ``sweep``, ``window`` and ``pixels_per_lane`` are
    ignored."""
    refuse_unported(layout=layout)
    meshlib.validate(mesh)
    del ray_tile, park_residuals, sweep, window, pixels_per_lane

    def f(params, cam_cfg, target):
        scene = Scene(params=params, mat_type=mat_type, active=active)
        loss_v, img, d_sm, d_cr = fused_train(
            scene, cam_cfg, target, img_width, img_height, samples_per_pixel,
            max_depth, seed=seed, gamma=gamma, pixel_order=pixel_order,
            rr_start=rr_start, loss=loss, huber_delta=huber_delta,
            layout=layout, mesh=mesh)
        grads = chain_to_params(d_sm, d_cr, params, cam_cfg, mat_type,
                                active, img_width, img_height)
        return loss_v, img, grads

    return f


@trace.spanned("rt.chain")
def chain_to_params(d_scene_mat, d_cam_row, params, cam_cfg, mat_type,
                    active, img_width: int, img_height: int):
    """Packed-matrix and camera-row cotangents -> (SceneParams,
    CameraConfig) cotangents. The scene's is the packing's inverse, a read
    of the matrix's columns (``kernel_io.scene_cotangent``, span
    ``rt.chain.scene``; ``mat_type`` and ``active`` take none); the
    camera's is autograd through ``pack_camera(initialize(...))``
    (``rt.chain.camera``, where the camera lives: the host, by default;
    its forward pass ``rt.camera``, as ``kernel_io.camera_row``'s)."""
    del mat_type, active
    with trace.span("rt.chain.scene"):
        d_params = kio.scene_cotangent(d_scene_mat, params)
    c_leaves = [t.detach().requires_grad_(True)
                for t in config_leaves(cam_cfg)]
    with torch.enable_grad(), trace.span("rt.chain.camera"):
        with trace.span("rt.camera"):
            row = kio.pack_camera(initialize(
                config_from_leaves(c_leaves), img_width, img_height))
        with trace.sync():
            d_cam = d_cam_row.to(row.device)
        dc = torch.autograd.grad(row, c_leaves, d_cam, allow_unused=True)
    return d_params, config_from_leaves([
        torch.zeros_like(leaf) if g is None else g
        for g, leaf in zip(dc, c_leaves)])
