"""Streamed scenes: the block-walk render kernel.

The counterpart of ``raytracingincuda_tpu/ops/pallas_stream.py``. A
scene of any size (1M spheres and more) is prepared once on the host:
its active spheres Morton-sorted into blocks of ``block`` matrix rows,
with one conservative bound sphere per block (``prepare_stream_scene``).
The closest hit then walks the blocks in the order of the bounds rows and
opens a block only where the ray can beat its current best inside the
block's bound.

Two implementations share one signature:

  * ``stream_kernel`` launches the hand-written CUDA kernel
    (``csrc/stream_render.cu``, one thread per pixel) on CUDA tensors;
  * ``stream_reference`` is the plain PyTorch version: the regen
    recurrence of ``render_kernel._regen_lanes`` with the all-slot hit
    test swapped for the walk (``_Walk``).

``_stream`` picks the kernel for CUDA tensors and the plain version only
for CPU tensors; nothing falls back from one to the other.
``render_stream`` is the ``render_pallas_stream`` counterpart.

What differs from the TPU layout: the stream matrix has the 16 columns
of ``pack_scene_matrix`` (the TPU padded it to 128 lanes for its DMA
slices) with the stream row id in column ``STREAM_COL_SID``. Block size,
the block count cap, the padding and ``perm`` are JAX's, so a JAX
``StreamScene`` carries over array for array
(``models/convert.stream_scene_from_numpy``). A tie between blocks goes to
the block visited first, and the walk compares ``t``, so a stream image
equals the ``hbm`` regen image except at exact ties between blocks.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.camera import CameraConfig
from ..models.scene import Scene, _round_up
from ..parallel import mesh as meshlib
from ..utils import trace
from . import f32math
from . import render_kernel as rk
from . import rng as rtrng
from . import vec
from .intersect import T_MIN, T_MISS, HitResult, hit_world

DEFAULT_BLOCK = 256
# stream-row id (the matrix row, as f32, exact below 2^24): the gradient
# kernels key their cotangents on it
STREAM_COL_SID = 11
# The TPU kernel kept the bounds table in SMEM and capped the block count;
# the cap stays so that block sizes (and so arrays) match the JAX package's.
_MAX_BLOCKS = 1792


class StreamScene(NamedTuple):
    """A prepared streamed scene, on one device."""
    scene_mat: torch.Tensor     # (n_pad, 16) f32, n_pad % block == 0
    bounds: torch.Tensor        # (nb, 8) f32: cx, cy, cz, r_bound, first row
    block: int
    # scene slot of each active stream row (n_active,) int32: maps
    # stream-order gradients back to scene order
    perm: Optional[torch.Tensor] = None

    @property
    def n_blocks(self) -> int:
        return self.scene_mat.shape[0] // self.block


def _morton3(q: np.ndarray, bits: int = 10) -> np.ndarray:
    """Interleave 3 x bits-bit integer coords -> Morton codes (N,)."""
    out = np.zeros(q.shape[0], np.uint64)
    for b in range(bits):
        for a in range(3):
            out |= ((q[:, a].astype(np.uint64) >> b) & 1) << (3 * b + a)
    return out


def _auto_block(n_act: int, block: int) -> int:
    """``block`` doubled until at most ``_MAX_BLOCKS`` blocks of it hold
    ``n_act`` rows in pairs."""
    while _round_up(max(n_act, 1), 2 * block) // block > _MAX_BLOCKS:
        block *= 2
    return block


def front_to_back(bounds: np.ndarray, point) -> np.ndarray:
    """The order of the bounds rows front to back from ``point``: by
    centre distance minus bound radius (in f64), empty blocks last,
    stable. The walk's best hit then tightens on near blocks first, so far
    blocks cull; any order gives the same image but for exact ties between
    blocks."""
    p = np.asarray([float(x) for x in point], np.float64)
    dist = np.sqrt(((bounds[:, 0:3] - p) ** 2).sum(1)) - bounds[:, 3]
    dist = np.where(bounds[:, 3] > 0.0, dist, np.inf)
    return np.argsort(dist, kind="stable")


def prepare_stream_scene(scene: Scene, block: int = DEFAULT_BLOCK,
                         sort: bool = True, dtype=torch.float32,
                         pad_pairs: bool = True, dense: bool = False,
                         camdist_from=None) -> StreamScene:
    """Sort the active spheres by the Morton code of their centres, pad to
    whole blocks (pairs of blocks with ``pad_pairs``, as the JAX package
    pads), and compute one conservative bound sphere per block. Host numpy,
    as in JAX, so the arrays equal the JAX package's bit for bit; the
    result lives on the scene's device.

    ``block`` is a minimum: it doubles while the scene would need more than
    ``_MAX_BLOCKS`` blocks. ``camdist_from`` (a point, the camera centre)
    reorders the bounds rows front to back by (distance - bound radius),
    empty blocks last. ``dense`` chose the TPU's 16-column layout; the
    port's matrix always has 16 columns, so it changes nothing."""
    del dense
    if dtype not in (torch.float32, np.float32, "float32"):
        raise NotImplementedError("stream scenes are float32 only")
    dev = scene.mat_type.device
    mat = rk.pack_scene_matrix(scene).detach().cpu().numpy()
    active = mat[:, rk.COL_ACTIVE] > 0.5
    n_act = int(active.sum())

    act_idx = np.flatnonzero(active)
    act_mat = mat[active]
    if sort and n_act > 1:
        c = act_mat[:, rk.COL_CX:rk.COL_CZ + 1].astype(np.float64)
        lo = c.min(0)
        span = np.maximum(c.max(0) - lo, 1e-9)
        q = np.clip(((c - lo) / span * 1023.0), 0, 1023).astype(np.uint32)
        order = np.argsort(_morton3(q), kind="stable")
        act_mat = act_mat[order]
        act_idx = act_idx[order]

    block = _auto_block(n_act, block)
    n_pad = _round_up(max(n_act, 1), (2 if pad_pairs else 1) * block)
    out = np.zeros((n_pad, rk.NUM_COLS), np.float32)
    out[:n_act] = act_mat
    # padding rows: radius 0, inactive (never hit), centres at the origin
    nb = n_pad // block
    bounds = np.zeros((nb, 8), np.float32)
    for b in range(nb):
        blk = out[b * block:(b + 1) * block]
        a_blk = blk[blk[:, rk.COL_ACTIVE] > 0.5]
        if a_blk.shape[0] == 0:
            continue                                  # empty: r_bound 0
        c = a_blk[:, rk.COL_CX:rk.COL_CZ + 1]
        r = a_blk[:, rk.COL_RADIUS]
        lo, hi = c.min(0), c.max(0)
        ctr = (lo + hi) * 0.5
        # |r|: a negative (hollow-glass) radius still occupies |r|
        rb = np.sqrt(((c - ctr) ** 2).sum(1)).max() + np.abs(r).max()
        bounds[b, 0:3] = ctr
        bounds[b, 3] = rb * 1.0001 + 1e-4             # conservative slack
    # column 4: the block's first matrix row, so reordering the bounds
    # rows alone reorders the walk
    bounds[:, 4] = np.arange(nb, dtype=np.float32) * block
    if camdist_from is not None and nb > 1:
        bounds = bounds[front_to_back(bounds, camdist_from)]
    out[:, STREAM_COL_SID] = np.arange(n_pad, dtype=np.float32)
    return StreamScene(torch.from_numpy(out).to(dev),
                       torch.from_numpy(bounds).to(dev), block,
                       torch.from_numpy(act_idx.astype(np.int32)).to(dev))


@trace.spanned("rt.stream.rebuild")
def build_stream_arrays(scene: Scene, perm: torch.Tensor, block: int,
                        n_pad: int, border=None):
    """(scene_mat, bounds) rebuilt on the scene's device from the current
    parameters under a frozen ``perm`` (the training path): the matrix
    exactly as ``prepare_stream_scene`` packs it, the bounds recomputed per
    block (to an ulp of the numpy ones: another summation order and
    sqrt). A stale sort only loosens culling. ``border`` (a permutation of
    the canonical block order, ``grad.front_to_back_border``) reorders the
    bounds rows."""
    with torch.no_grad():
        mat = rk.pack_scene_matrix(scene)
        dev = mat.device
        n_act = perm.shape[0]
        out = torch.zeros((n_pad, rk.NUM_COLS), dtype=torch.float32,
                          device=dev)
        out[:n_act] = mat[perm.long()]
        out[:, STREAM_COL_SID] = torch.arange(n_pad, dtype=torch.float32,
                                              device=dev)
        nb = n_pad // block
        c = out[:, rk.COL_CX:rk.COL_CZ + 1].reshape(nb, block, 3)
        r = out[:, rk.COL_RADIUS].reshape(nb, block)
        act = out[:, rk.COL_ACTIVE].reshape(nb, block) > 0.5
        with trace.sync():
            big = torch.tensor(1e30, dtype=torch.float32, device=dev)
        lo = torch.where(act[..., None], c, big).amin(1)
        hi = torch.where(act[..., None], c, -big).amax(1)
        any_act = act.any(1)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        ctr = torch.where(any_act[:, None], (lo + hi) * 0.5, zero)
        dist = f32math.sqrt(((c - ctr[:, None, :]) ** 2).sum(-1))
        dmax = torch.where(act, dist, zero).amax(1)
        rmax = torch.where(act, r.abs(), zero).amax(1)
        rb = torch.where(any_act, (dmax + rmax) * 1.0001 + 1e-4, zero)
        bounds = torch.zeros((nb, 8), dtype=torch.float32, device=dev)
        bounds[:, 0:3] = ctr
        bounds[:, 3] = rb
        bounds[:, 4] = torch.arange(nb, dtype=torch.float32,
                                    device=dev) * block
        if border is not None:
            bounds = bounds[torch.as_tensor(border, device=dev).long()]
    return out, bounds.contiguous()


def reorder_front_to_back(stream: StreamScene, point) -> StreamScene:
    """``stream`` with its bounds rows front to back from ``point`` (the
    matrix does not move)."""
    bn = stream.bounds.cpu().numpy()
    if bn.shape[0] <= 1:
        return stream
    order = torch.from_numpy(front_to_back(bn, point))
    return stream._replace(bounds=stream.bounds[order.to(stream.bounds.device)])


# -- the plain version ---------------------------------------------------------

def _block_bound_any_hit(b, o, d, a, d_dot_o, o2, t_cur):
    """Per lane: can the ray beat ``t_cur`` inside the bound sphere ``b``
    (0-d tensors cx, cy, cz, r)? ``pallas_stream.py:_block_bound_any_hit``
    without its max over lanes; path_common.cuh's ``bound_can_improve``."""
    bx, by, bz, br = b
    cdx = bx * d.x + by * d.y + bz * d.z
    cdo = bx * o.x + by * o.y + bz * o.z
    h = cdx - d_dot_o
    c2r2 = bx * bx + by * by + bz * bz - br * br
    c = (c2r2 + o2) - 2.0 * cdo
    disc = h * h - a * c
    pos = disc > 0.0
    sqrtd = f32math.sqrt(torch.where(pos, disc, torch.zeros_like(disc)))
    return (pos & (h + sqrtd > T_MIN * a) & (h - sqrtd < t_cur * a)
            & (br > 0.0))


class _Walk:
    """The stream walk's closest hit, plain version: ``hit_world``'s
    contract over the stream rows. Per bounds row in order, the bound test
    per lane; the lanes that pass (and trace this wave) merge the block's
    hit (``hit_world`` on its rows) where ``t_b < t_cur``. After
    ``count(lanes, device)`` it counts the kernel's work: the blocks each
    lane opened, and per warp of 32 lanes the blocks any of its lanes opened at
    each call, the union that the kernel's warp tests (a call is one wave,
    one traced segment per tracing lane, as one iteration of the kernel's
    regenerating loop)."""

    def __init__(self, scene_mat: torch.Tensor, bounds: torch.Tensor,
                 block: int):
        self.bounds = [tuple(row) for row in bounds[:, :4].unbind(0)]
        self.first = [int(v) for v in bounds[:, 4].tolist()]
        self.blocks = [rk.scene_from_matrix(scene_mat[k:k + block])
                       for k in self.first]
        self.opened = self.fetched = None

    def count(self, lanes: int, device):
        self.opened = torch.zeros(lanes, dtype=torch.int64, device=device)
        self.fetched = torch.zeros(lanes // rk.WARP, dtype=torch.int64,
                                   device=device)

    def __call__(self, o, d, active) -> HitResult:
        a = vec.maximum(vec.length_sq(d), 1e-12)
        d_dot_o = vec.dot(d, o)
        o2 = vec.length_sq(o)
        t_cur = torch.full_like(a, T_MISS)
        win = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
        for b, k0, blk in zip(self.bounds, self.first, self.blocks):
            can = active & _block_bound_any_hit(b, o, d, a, d_dot_o, o2, t_cur)
            if not bool(can.any()):
                continue
            if self.opened is not None:
                self.opened += can
                self.fetched += can.view(-1, rk.WARP).any(1)
            h = hit_world(blk, o, d)
            better = can & h.hit & (h.t < t_cur)
            t_cur = torch.where(better, h.t, t_cur)
            win = torch.where(better, h.idx + k0, win)
        return HitResult(hit=t_cur < T_MISS, t=t_cur, idx=win)


def _check(ids, ii, jj, budget, scene_mat, bounds, cam_row, *, block,
           samples, max_depth, rr_start, sample_offset):
    """What both implementations take; raises on anything else."""
    rr_start = rk._check_args(ids, ii, jj, budget, scene_mat, cam_row,
                              samples=samples, max_depth=max_depth,
                              rr_start=rr_start, sample_offset=sample_offset,
                              layout="hbm")
    if bounds.device != ids.device or bounds.dtype != torch.float32:
        raise ValueError("bounds must be f32 on the lanes' device")
    if (bounds.dim() != 2 or bounds.shape[1] != 8
            or not bounds.is_contiguous()):
        raise ValueError(f"bounds must be a contiguous (nb, 8) array, got "
                         f"{tuple(bounds.shape)}")
    if block < 1 or scene_mat.shape[0] % block:
        raise ValueError(f"the stream matrix's {scene_mat.shape[0]} rows "
                         f"are not whole blocks of {block}")
    if bounds.shape[0] > scene_mat.shape[0] // block:
        raise ValueError(f"{bounds.shape[0]} bounds rows for "
                         f"{scene_mat.shape[0] // block} blocks")
    first = bounds[:, 4]  # each row's first matrix row: the walk reads there
    ok = ((first >= 0) & (first + block <= scene_mat.shape[0])
          & (torch.remainder(first, block) == 0)).all()
    with trace.sync():
        ok = bool(ok)
    if not ok:
        raise ValueError("bounds column 4 must hold each block's first "
                         "matrix row, a multiple of the block inside the "
                         "matrix")
    return rr_start


def stream_reference(ids, ii, jj, budget, scene_mat, bounds, cam_row, *,
                     block: int, samples: int, max_depth: int,
                     seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                     sample_offset: int = 0,
                     finalize_scale: Optional[float] = None,
                     emit_stats: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the stream kernel; ``regen_reference``'s
    contract with the stream matrix and its bounds in place of the scene.
    With ``emit_stats`` it returns the work instead of the image, a (3,
    padded) f32 tensor: each lane's traced segments, the blocks its walk
    opened, and at each warp's first lane the blocks that the warp of 32
    lanes tested (at each iteration of the regenerating loop, the union of
    its lanes' opened blocks; 0 at the other lanes)."""
    rr_start = _check(ids, ii, jj, budget, scene_mat, bounds, cam_row,
                      block=block, samples=samples, max_depth=max_depth,
                      rr_start=rr_start, sample_offset=sample_offset)
    chunk = max(rk.PAD, rk._REFERENCE_CHUNK_ELEMS // block // rk.PAD * rk.PAD)
    walk = _Walk(scene_mat, bounds, block)
    scene = rk.scene_from_matrix(scene_mat)
    cam = rk.unpack_camera(cam_row)
    outs = []
    for lanes in zip(ids.split(chunk), ii.split(chunk), jj.split(chunk),
                     budget.split(chunk)):
        if emit_stats:
            walk.count(lanes[0].shape[0], lanes[0].device)
        out = rk._regen_lanes(*lanes, scene, cam, samples=samples,
                              max_depth=max_depth, seed=seed,
                              legacy_sky=False, emit_depth=emit_stats,
                              rr_start=rr_start, sample_offset=sample_offset,
                              finalize_scale=finalize_scale, hit_fn=walk)
        if emit_stats:
            fetched = torch.zeros((walk.fetched.shape[0], rk.WARP),
                                  device=out.device)
            fetched[:, 0] = walk.fetched.float()
            out = torch.cat([out, walk.opened.float()[None],
                             fetched.reshape(1, -1)])
        outs.append(out)
    return torch.cat(outs, dim=1)


# -- the CUDA launcher ----------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_C_ARGTYPES = [
    _P, _P, _P, _P,     # ids (int32), ii, jj, budget
    _P, _I,             # stream matrix SoA (11, rows), rows
    _P,                 # scan table (rows, 4), written by the call
    _P, _I, _I,         # bounds (nb, 8), nb, block
    _P,                 # cam row
    _P, _I, _I,         # out, padded, max_depth
    _U, _U,             # key words
    _I, _I,             # sample_offset, rr_start (-1 = off)
    _I, _F,             # fused finalize, its scale
    _I,                 # emit the work counts instead of radiance
    _P,                 # cudaStream_t
]


def soa(scene_mat: torch.Tensor) -> torch.Tensor:
    """The kernels' view of a stream matrix: columns 0-10 as (11, rows)."""
    return scene_mat[:, :rk.USED_COLS].t().contiguous()


def scan_buffer(scene_mat: torch.Tensor) -> torch.Tensor:
    """Room for the (rows, 4) scan table that each kernel-4 or kernel-5
    call builds from the stream matrix (cx, cy, cz, |C|^2 - r^2 or NaN)."""
    return torch.empty((scene_mat.shape[0], 4), dtype=torch.float32,
                       device=scene_mat.device)


@trace.spanned("rt.launch.stream_render")
def stream_kernel(ids, ii, jj, budget, scene_mat, bounds, cam_row, *,
                  block: int, samples: int, max_depth: int,
                  seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                  sample_offset: int = 0,
                  finalize_scale: Optional[float] = None,
                  emit_stats: bool = False) -> torch.Tensor:
    """Launch the CUDA stream kernel, after the scan-table kernel that
    builds its walk's input; same contract as ``stream_reference``.
    Launches on the current stream without synchronising. Counts
    ``launch.stream_render``."""
    if ids.device.type != "cuda":
        raise ValueError(f"stream_kernel takes CUDA tensors, got {ids.device}")
    rr_start = _check(ids, ii, jj, budget, scene_mat, bounds, cam_row,
                      block=block, samples=samples, max_depth=max_depth,
                      rr_start=rr_start, sample_offset=sample_offset)
    from . import _build

    launch = _build.function("stream_render", _C_ARGTYPES)
    padded = ids.shape[0]
    rows, scan = soa(scene_mat), scan_buffer(scene_mat)
    out = torch.empty((3, padded), dtype=torch.float32, device=ids.device)
    k0, k1 = rtrng.key_from_seed(seed)
    err = launch(
        ids.data_ptr(), ii.data_ptr(), jj.data_ptr(), budget.data_ptr(),
        rows.data_ptr(), scene_mat.shape[0], scan.data_ptr(),
        bounds.data_ptr(), bounds.shape[0], block, cam_row.data_ptr(),
        out.data_ptr(), padded,
        max_depth, k0, k1, sample_offset,
        -1 if rr_start is None else rr_start,
        int(finalize_scale is not None),
        0.0 if finalize_scale is None else finalize_scale, int(emit_stats),
        torch.cuda.current_stream(ids.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stream_render launch failed: CUDA error {err}")
    trace.count("launch.stream_render")
    return out


def _stream(ids, *args, **kw) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if ids.device.type == "cuda":
        return stream_kernel(ids, *args, **kw)
    if ids.device.type == "cpu":
        return stream_reference(ids, *args, **kw)
    raise ValueError(f"no stream implementation for device {ids.device}")


# -- the entry point ------------------------------------------------------------

def render_stream(stream: StreamScene, cam_cfg: CameraConfig, img_width: int,
                  img_height: int, samples_per_pixel: int, max_depth: int, *,
                  seed: int = rtrng.DEFAULT_SEED, dtype=torch.float32,
                  gamma: bool = True, rr_start=None, sample_offset: int = 0,
                  sample_budgets=None, pixel_order=None,
                  accumulate_only: bool = False, mesh=None) -> torch.Tensor:
    """Render a prepared ``StreamScene`` on its device; (H, W, 3) f32.

    ``render_kernel.render_kernel``'s contract: ``sample_offset`` /
    ``sample_budgets`` / ``accumulate_only`` render samples ``[offset,
    offset + budget)`` per pixel as raw sums; ``pixel_order`` changes speed
    only; uniform-budget gamma renders finish 1/spp and gamma in the
    kernel. The TPU schedule's keywords (``ray_tile``, ``lane_group``,
    ``pixels_per_lane``, ``resident``) have no counterpart. ``mesh``
    (``parallel.mesh.Mesh``): this rank renders its slice of the lanes and
    the image reaches every rank (one ``all_reduce``)."""
    from .train_kernel import refuse_unported

    refuse_unported(dtype)
    dev = stream.scene_mat.device
    cam_row = rk.camera_row(cam_cfg, img_width, img_height, dev)
    ids, ii, jj, budget = rk._lane_setup(img_width, img_height, pixel_order,
                                         samples_per_pixel, sample_offset,
                                         sample_budgets, dev, mesh)
    fuse = gamma and not accumulate_only and sample_budgets is None
    out = _stream(*rk.shard(mesh, ids, ii, jj, budget), stream.scene_mat,
                  stream.bounds, cam_row, block=stream.block,
                  samples=samples_per_pixel, max_depth=max_depth, seed=seed,
                  rr_start=rr_start, sample_offset=sample_offset,
                  finalize_scale=1.0 / samples_per_pixel if fuse else None)
    out = meshlib.gather_lanes(mesh, out, ids.shape[0])
    return rk._finalize_output(out, ids, pixel_order is not None, img_width,
                               img_height, samples_per_pixel, gamma,
                               accumulate_only, already_finalized=fuse)
