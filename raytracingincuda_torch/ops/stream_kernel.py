"""Streamed scenes: the block-walk render kernel.

The counterpart of ``raytracingincuda_tpu/ops/pallas_stream.py``. A
scene of any size (1M spheres and more) is prepared once on the host:
its active spheres Morton-sorted into blocks of ``block`` matrix rows,
with one conservative bound sphere per block (``prepare_stream_scene``).
The closest hit then walks the blocks in the order of the bounds rows and
opens a block only where the ray can beat its current best inside the
block's bound; the kernels then test only the groups of ``GROUP`` rows
whose box the ray can improve in (``walk_groups_reference``), which gives
the same hit.

Two implementations share one signature:

  * ``stream_kernel`` launches the hand-written CUDA kernel
    (``csrc/stream_render.cu``, one thread per pixel) on CUDA tensors;
  * ``stream_reference`` is the plain PyTorch version: the regen
    recurrence of ``render_kernel.regen_lanes`` with the all-slot hit
    test swapped for the walk (``Walk``).

``_stream`` (``kernel_io.by_device``) picks the kernel for CUDA tensors
and the plain version only for CPU tensors; nothing falls back from one to
the other. ``check_args`` is ``kernel_io.check`` with the walk's rules; it
reads a bounds table's column 4 on the host only where this module did not
build the table itself (``prepare_stream_scene``, ``reorder_front_to_back``,
``build_stream_arrays``), so a step on bounds built here never waits for
the card. ``render_stream`` is the ``render_pallas_stream`` counterpart.

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
from ..models.scene import Scene, round_up
from ..parallel import mesh as meshlib
from ..utils import trace
from . import f32math
from . import group_scan as gs
from . import kernel_io as kio
from . import render_kernel as rk
from . import rng as rtrng
from . import vec
from .intersect import T_MIN, T_MISS, HitResult, hit_world, root_numerators
from .kernel_io import COL_ACTIVE, COL_CX, COL_CZ, COL_RADIUS, WARP

DEFAULT_BLOCK = 256
# stream-row id (the matrix row, as f32, exact below 2^24): the gradient
# kernels key their cotangents on it
STREAM_COL_SID = 11
# The TPU kernel kept the bounds table in SMEM and capped the block count;
# the cap stays so that block sizes (and so arrays) match the JAX package's.
_MAX_BLOCKS = 1792
# The walk's second level (csrc/staged_walk.cuh): groups of GROUP matrix
# rows inside each block, each behind a box widened by BOX_PAD per unit of
# |M| + R + |o| and by SLACK; a lane whose ray lies outside SAFE tests every
# group with an active row.
GROUP, SAFE, SLACK = gs.GROUP, gs.SAFE, gs.SLACK
BOX_PAD = gs.constants("staged_walk.cuh")["kBoxPad"]


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


def _vouch(bounds: torch.Tensor, rows: int, block: int) -> torch.Tensor:
    """Mark ``bounds`` as built by this module for a matrix of ``rows`` rows
    in blocks of ``block``: the mark holds while the tensor's version does,
    so a write in place voids it, and a copy or a new tensor carries none."""
    bounds._rt_vouched = (bounds._version, rows, block)
    return bounds


def _vouched(bounds: torch.Tensor, rows: int, block: int) -> bool:
    """Whether ``_vouch(bounds, rows, block)`` marked ``bounds`` and it is
    unchanged since."""
    return (getattr(bounds, "_rt_vouched", None)
            == (bounds._version, rows, block))


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
    while round_up(max(n_act, 1), 2 * block) // block > _MAX_BLOCKS:
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
    mat = kio.pack_scene_matrix(scene).detach().cpu().numpy()
    active = mat[:, COL_ACTIVE] > 0.5
    n_act = int(active.sum())

    act_idx = np.flatnonzero(active)
    act_mat = mat[active]
    if sort and n_act > 1:
        c = act_mat[:, COL_CX:COL_CZ + 1].astype(np.float64)
        lo = c.min(0)
        span = np.maximum(c.max(0) - lo, 1e-9)
        q = np.clip(((c - lo) / span * 1023.0), 0, 1023).astype(np.uint32)
        order = np.argsort(_morton3(q), kind="stable")
        act_mat = act_mat[order]
        act_idx = act_idx[order]

    block = _auto_block(n_act, block)
    n_pad = round_up(max(n_act, 1), (2 if pad_pairs else 1) * block)
    out = np.zeros((n_pad, kio.NUM_COLS), np.float32)
    out[:n_act] = act_mat
    # padding rows: radius 0, inactive (never hit), centres at the origin
    nb = n_pad // block
    bounds = np.zeros((nb, 8), np.float32)
    for b in range(nb):
        blk = out[b * block:(b + 1) * block]
        a_blk = blk[blk[:, COL_ACTIVE] > 0.5]
        if a_blk.shape[0] == 0:
            continue                                  # empty: r_bound 0
        c = a_blk[:, COL_CX:COL_CZ + 1]
        r = a_blk[:, COL_RADIUS]
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
                       _vouch(torch.from_numpy(bounds).to(dev), n_pad,
                              block), block,
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
    bounds rows. The bounds are vouched for (``check_args`` reads nothing of
    them on the host): column 4 is written here, and a ``border`` index out
    of range raises in the gather. Counts ``stream.rows`` by the matrix rows
    it writes."""
    trace.count("stream.rows", n_pad)
    with torch.no_grad():
        mat = kio.pack_scene_matrix(scene)
        dev = mat.device
        n_act = perm.shape[0]
        out = torch.zeros((n_pad, kio.NUM_COLS), dtype=torch.float32,
                          device=dev)
        out[:n_act] = mat[perm.long()]
        out[:, STREAM_COL_SID] = torch.arange(n_pad, dtype=torch.float32,
                                              device=dev)
        nb = n_pad // block
        c = out[:, COL_CX:COL_CZ + 1].reshape(nb, block, 3)
        r = out[:, COL_RADIUS].reshape(nb, block)
        act = out[:, COL_ACTIVE].reshape(nb, block) > 0.5
        lo = torch.where(act[..., None], c, 1e30).amin(1)
        hi = torch.where(act[..., None], c, -1e30).amax(1)
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
    return out, _vouch(bounds.contiguous(), n_pad, block)


def front_to_back_order(bounds: torch.Tensor, point) -> tuple:
    """``front_to_back`` of a bounds table on any device: (the order of its
    rows, int64 on the bounds' device; the rows in that order, a numpy
    copy on the host). The read of the bounds on the host and the order's
    copy back are one host wait (``trace.sync``); a scene or a fit takes
    it once."""
    with trace.sync():
        host = bounds.detach().cpu().numpy()
        order = front_to_back(host, point)
        return torch.from_numpy(order).to(bounds.device), host[order]


def reorder_front_to_back(stream: StreamScene, point) -> StreamScene:
    """``stream`` with its bounds rows front to back from ``point`` (the
    matrix does not move); vouched for where ``stream``'s bounds were."""
    if stream.bounds.shape[0] <= 1:
        return stream
    what = (stream.scene_mat.shape[0], stream.block)
    bounds = stream.bounds[front_to_back_order(stream.bounds, point)[0]]
    if _vouched(stream.bounds, *what):
        _vouch(bounds, *what)
    return stream._replace(bounds=bounds)


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


def block_groups(block: int) -> int:
    """Groups of the walk's second level in a block of ``block`` rows."""
    return -(-block // GROUP)


def walk_groups(rows: int, block: int) -> int:
    """Groups in a stream matrix of ``rows`` rows in blocks of ``block``."""
    return rows // block * block_groups(block)


def walk_groups_reference(scene_mat: torch.Tensor, block: int) -> torch.Tensor:
    """The plain twin of ``staged_walk.cuh``'s group table: (walk_groups,
    8) f32 on the matrix's device, a group's box centre C, 0, then its
    half-extents E, 0 (``group_box``: E = -inf for a group with no active
    row, +inf with an active row outside ``SAFE``, C = 0 for both),
    computed on the CPU in f32 with the kernel's association. Group g of
    block b holds rows [b block + g GROUP, min(that + GROUP, (b + 1)
    block))."""
    m = scene_mat.detach().to("cpu", torch.float32)
    n, per = m.shape[0], block_groups(block)
    nb = n // block
    first = (torch.arange(nb)[:, None] * block
             + torch.arange(per)[None, :] * GROUP).reshape(-1, 1)
    k = first + torch.arange(GROUP)[None, :]                  # (ng, GROUP)
    end = (first // block + 1) * block
    have = k < end
    rows = m[torch.where(have, k, torch.zeros_like(k))]
    c, r = rows[..., 0:3], rows[..., 3]
    act = have & (rows[..., 10] > 0.5)
    inside = (((c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1])
               + c[..., 2] * c[..., 2]) + r * r) <= SAFE
    inf = torch.tensor(float("inf"))
    lo = torch.where(act[..., None], c, inf).amin(1) + 0.0
    hi = torch.where(act[..., None], c, -inf).amax(1) + 0.0
    rmax = torch.where(act, r.abs(), torch.zeros_like(r)).amax(1)
    ctr = (lo + hi) * 0.5
    mm = torch.maximum(lo.abs(), hi.abs())
    cn = f32math.sqrt((mm[:, 0] * mm[:, 0] + mm[:, 1] * mm[:, 1])
                      + mm[:, 2] * mm[:, 2])
    w = (rmax + BOX_PAD * (cn + rmax)) + SLACK
    out = torch.zeros((k.shape[0], 8), dtype=torch.float32)
    out[:, 0:3] = ctr
    out[:, 4:7] = torch.maximum(hi - ctr, ctr - lo) + w[:, None]
    empty = ~act.any(1)
    outside = ~empty & (act & ~inside).any(1)
    out[empty | outside, 0:3] = 0.0
    out[empty, 4:7] = -inf
    out[outside, 4:7] = inf
    return out.to(scene_mat.device)


def _box_ray(o, d):
    """What the box test reads of each lane's ray (staged_walk.cuh's
    ``WalkRay``): o, a / d an axis, BOX_PAD |o|, T_MIN a and ``wide``."""
    dd, o2 = vec.length_sq(d), vec.length_sq(o)
    a = vec.maximum(dd, 1e-12)
    wide = ~((dd >= 1e-12) & (dd <= SAFE) & (o2 <= SAFE))
    return ((o.x, o.y, o.z), (a / d.x, a / d.y, a / d.z),
            BOX_PAD * f32math.sqrt(o2), T_MIN * a, wide)


def _box_can_improve(g, ray, cap):
    """Per lane: can the ray's root numerator improve on ``cap`` inside the
    group box ``g`` (a row of ``walk_groups_reference``)? staged_walk.cuh's
    ``box_can_improve``: the slab test, NaN ends dropped (``fmax``)."""
    o, s, pad_o, tmin_a, wide = ray
    m = [(g[i] - oi) * si for i, (oi, si) in enumerate(zip(o, s))]
    h = [(g[4 + i] + pad_o) * si.abs() for i, si in enumerate(s)]
    near = torch.fmax(torch.fmax(m[0] - h[0], m[1] - h[1]), m[2] - h[2])
    far = torch.fmin(torch.fmin(m[0] + h[0], m[1] + h[1]), m[2] + h[2])
    return torch.where(wide, g[4] >= 0.0,
                       (near <= torch.minimum(far, cap)) & (far > tmin_a))


class Walk:
    """The stream walk's closest hit, plain version: ``hit_world``'s
    contract over the stream rows. Per bounds row in order, the bound test
    per lane; the lanes that pass (and trace this wave) merge the block's
    hit where ``t_b < t_cur``. The block's hit is ``hit_world`` on its rows;
    with ``groups`` (a ``walk_groups_reference`` table), the kernel's two
    levels: its groups in row order, a warp of 32 lanes testing a group's
    rows where some lane that opened the block passes the group's box at
    min(its best in the block, t_cur a), which gives the same hit
    (``staged_walk.cuh``'s header). After ``count(lanes, device)`` it counts
    the kernel's work: the blocks each lane opened; per warp the blocks any
    of its lanes opened at each call, the union that the kernel's warp walks
    (a call is one wave, one traced segment per tracing lane, as one
    iteration of the kernel's regenerating loop); and with ``groups`` the
    rows each warp tested."""

    def __init__(self, scene_mat: torch.Tensor, bounds: torch.Tensor,
                 block: int, groups: Optional[torch.Tensor] = None):
        self.bounds = [tuple(row) for row in bounds[:, :4].unbind(0)]
        self.first = [int(v) for v in bounds[:, 4].tolist()]
        self.blocks = [kio.scene_from_matrix(scene_mat[k:k + block])
                       for k in self.first]
        self.block = block
        self.groups = None
        if groups is not None:
            per = block_groups(block)
            self.groups = [groups[k // block * per:(k // block + 1) * per]
                           for k in self.first]
        self.opened = self.fetched = self.tested = None

    def count(self, lanes: int, device):
        self.opened = torch.zeros(lanes, dtype=torch.int64, device=device)
        self.fetched = torch.zeros(lanes // WARP, dtype=torch.int64,
                                   device=device)
        self.tested = torch.zeros_like(self.fetched)

    def _grouped(self, blk, table, k0, can, o, d, a, t_cur):
        """The block's least root numerator and its row over the groups a
        warp tests (the kernel's second level)."""
        t_num, _ = root_numerators(blk, o, d)
        per, R = table.shape[0], t_num.shape[1]
        pad = per * GROUP - self.block
        if pad:
            t_num = torch.cat([t_num, t_num.new_full((pad, R), T_MISS)])
        gmin, garg = torch.min(t_num.view(per, GROUP, R), dim=1)
        ray = _box_ray(o, d)
        tca = t_cur * a
        best = torch.full_like(a, T_MISS)
        win = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
        for g in range(per):
            cap = torch.minimum(best, tca)
            warp = (can & _box_can_improve(table[g], ray, cap)).view(
                -1, WARP).any(1)
            if self.tested is not None:
                self.tested += warp * min(GROUP, self.block - g * GROUP)
            take = can & warp.repeat_interleave(WARP) & (gmin[g] < best)
            best = torch.where(take, gmin[g], best)
            win = torch.where(take, garg[g] + (k0 + g * GROUP), win)
        return best, win

    def __call__(self, o, d, active) -> HitResult:
        a = vec.maximum(vec.length_sq(d), 1e-12)
        d_dot_o = vec.dot(d, o)
        o2 = vec.length_sq(o)
        t_cur = torch.full_like(a, T_MISS)
        win = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
        for j, (b, k0, blk) in enumerate(zip(self.bounds, self.first,
                                             self.blocks)):
            can = active & _block_bound_any_hit(b, o, d, a, d_dot_o, o2, t_cur)
            if not bool(can.any()):
                continue
            if self.opened is not None:
                self.opened += can
                self.fetched += can.view(-1, WARP).any(1)
            if self.groups is None:
                h = hit_world(blk, o, d)
                h_t, h_idx = h.t, h.idx + k0
                better = can & h.hit & (h_t < t_cur)
            else:
                best, h_idx = self._grouped(blk, self.groups[j], k0, can, o,
                                            d, a, t_cur)
                h_t = best * (1.0 / a)
                better = can & (best < T_MISS) & (h_t < t_cur)
            t_cur = torch.where(better, h_t, t_cur)
            win = torch.where(better, h_idx, win)
        return HitResult(hit=t_cur < T_MISS, t=t_cur, idx=win)


def check_args(ids, ii, jj, rows, scene_mat, bounds, cam_row, *, block,
               **kw):
    """``kernel_io.check`` with the stream matrix as the scene (layout
    'hbm'), then the walk's rules: (nb, 8) f32 ``bounds``, at most a row a
    block of ``block`` matrix rows, column 4 a block's first matrix row.
    Column 4 is read on the host (a host wait) unless this module built the
    bounds for this matrix and block and they have not changed since."""
    rr_start = kio.check(ids, ii, jj, scene_mat, cam_row, rows=rows,
                         layout="hbm", **kw)
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
    if _vouched(bounds, scene_mat.shape[0], block):
        return rr_start
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
    With ``emit_stats`` it returns the work instead of the image, a (4,
    padded) f32 tensor: each lane's traced segments, the blocks its walk
    opened, and at each warp's first lane the blocks that the warp of 32
    lanes walked (at each iteration of the regenerating loop, the union of
    its lanes' opened blocks) and the rows it tested in them (the walk's
    two levels, ``Walk`` with ``walk_groups_reference``'s table); 0 at the
    other lanes."""
    rr_start = check_args(ids, ii, jj, budget, scene_mat, bounds, cam_row,
                          block=block, samples=samples, max_depth=max_depth,
                          rr_start=rr_start, sample_offset=sample_offset)
    chunk = kio.reference_chunk(block)
    walk = Walk(scene_mat, bounds, block, groups=(
        walk_groups_reference(scene_mat, block) if emit_stats else None))
    scene = kio.scene_from_matrix(scene_mat)
    cam = kio.unpack_camera(cam_row)
    outs = []
    for lanes in zip(ids.split(chunk), ii.split(chunk), jj.split(chunk),
                     budget.split(chunk)):
        if emit_stats:
            walk.count(lanes[0].shape[0], lanes[0].device)
        out = rk.regen_lanes(*lanes, scene, cam, samples=samples,
                             max_depth=max_depth, seed=seed,
                             legacy_sky=False, emit_depth=emit_stats,
                             rr_start=rr_start, sample_offset=sample_offset,
                             finalize_scale=finalize_scale, hit_fn=walk)
        if emit_stats:
            warps = torch.zeros((2, walk.fetched.shape[0], WARP),
                                device=out.device)
            warps[0, :, 0] = walk.fetched.float()
            warps[1, :, 0] = walk.tested.float()
            out = torch.cat([out, walk.opened.float()[None],
                             warps.reshape(2, -1)])
        outs.append(out)
    return torch.cat(outs, dim=1)


# -- the CUDA launcher ----------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_C_ARGTYPES = [
    _P, _P, _P, _P,     # ids (int32), ii, jj, budget
    _P, _I,             # stream matrix SoA (11, rows), rows
    _P,                 # the walk's tables (scan_buffer), written by the call
    _P, _I, _I,         # bounds (nb, 8), nb, block
    _P,                 # cam row
    _P, _I, _I,         # out, padded, max_depth
    _U, _U,             # key words
    _I, _I,             # sample_offset, rr_start (-1 = off)
    _I, _F,             # fused finalize, its scale
    _I,                 # emit the work counts instead of radiance
]


def scan_buffer(scene_mat: torch.Tensor, block: int) -> torch.Tensor:
    """Room for the walk's tables that each kernel-4 or kernel-5 launch
    builds from the stream matrix (``scan_table_kernel``): the (rows, 4) scan
    table (cx, cy, cz, |C|^2 - r^2 or NaN), then the group table, two rows
    a group (C, 0 and E, 0)."""
    rows = scene_mat.shape[0]
    return torch.empty((rows + 2 * walk_groups(rows, block), 4),
                       dtype=torch.float32, device=scene_mat.device)


def walk_tables_kernel(scene_mat: torch.Tensor, block: int):
    """The walk's tables built on the card (``stream_tables``, the launch
    before every walk): (the (rows, 4) scan table, the (walk_groups, 8)
    group table), for the tests and ``chip_smoke.py``. Counts
    ``launch.walk_tables``."""
    launch = kio.entry("stream_tables", [_P, _I, _I, _P], scene_mat.device)
    rows, table = kio.soa(scene_mat), scan_buffer(scene_mat, block)
    launch(rows.data_ptr(), scene_mat.shape[0], block, table.data_ptr())
    trace.count("launch.walk_tables")
    n = scene_mat.shape[0]
    return table[:n], table[n:].reshape(-1, 8)


def count_walk(bounds: torch.Tensor, block: int) -> None:
    """Count a walk launch's table launch (``launch.walk_tables``), its
    bounds rows (``stream.blocks``) and the group-table rows the table
    launch builds for their blocks (``stream.groups``)."""
    trace.count("launch.walk_tables")
    trace.count("stream.blocks", bounds.shape[0])
    trace.count("stream.groups", bounds.shape[0] * block_groups(block))


@trace.spanned("rt.launch.stream_render")
def stream_kernel(ids, ii, jj, budget, scene_mat, bounds, cam_row, *,
                  block: int, samples: int, max_depth: int,
                  seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                  sample_offset: int = 0,
                  finalize_scale: Optional[float] = None,
                  emit_stats: bool = False) -> torch.Tensor:
    """Launch the CUDA stream kernel, after the table kernel that builds
    its walk's input; same contract as ``stream_reference``. Launches on
    the current stream without synchronising. Counts
    ``launch.stream_render``, its table launch and its rows
    (``count_walk``)."""
    launch = kio.entry("stream_render", _C_ARGTYPES, ids.device)
    rr_start = check_args(ids, ii, jj, budget, scene_mat, bounds, cam_row,
                          block=block, samples=samples, max_depth=max_depth,
                          rr_start=rr_start, sample_offset=sample_offset)
    padded = ids.shape[0]
    rows, scan = kio.soa(scene_mat), scan_buffer(scene_mat, block)
    out = torch.empty((4 if emit_stats else 3, padded), dtype=torch.float32,
                      device=ids.device)
    k0, k1 = rtrng.key_from_seed(seed)
    launch(
        ids.data_ptr(), ii.data_ptr(), jj.data_ptr(), budget.data_ptr(),
        rows.data_ptr(), scene_mat.shape[0], scan.data_ptr(),
        bounds.data_ptr(), bounds.shape[0], block, cam_row.data_ptr(),
        out.data_ptr(), padded,
        max_depth, k0, k1, sample_offset,
        -1 if rr_start is None else rr_start,
        int(finalize_scale is not None),
        0.0 if finalize_scale is None else finalize_scale, int(emit_stats),
    )
    trace.count("launch.stream_render")
    count_walk(bounds, block)
    return out


_stream = kio.by_device(stream_kernel, stream_reference)


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
    cam_row = kio.camera_row(cam_cfg, img_width, img_height, dev)
    ids, ii, jj, budget = kio.lane_setup(img_width, img_height, pixel_order,
                                         samples_per_pixel, sample_offset,
                                         sample_budgets, dev, mesh)
    fuse = gamma and not accumulate_only and sample_budgets is None
    out = _stream(*kio.shard(mesh, ids, ii, jj, budget), stream.scene_mat,
                  stream.bounds, cam_row, block=stream.block,
                  samples=samples_per_pixel, max_depth=max_depth, seed=seed,
                  rr_start=rr_start, sample_offset=sample_offset,
                  finalize_scale=1.0 / samples_per_pixel if fuse else None)
    out = meshlib.gather_lanes(mesh, out, ids.shape[0])
    return kio.finalize_output(out, ids, pixel_order is not None, img_width,
                               img_height, samples_per_pixel, gamma,
                               accumulate_only, already_finalized=fuse)
