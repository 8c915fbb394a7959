"""Gradients and the fused train step for streamed scenes.

The counterpart of ``raytracingincuda_tpu/ops/pallas_stream_backward.py``:
``render_stream_grads`` (``render_pallas_stream_grads`` :904),
``mse_train_stream`` (:927) and ``stream_grads_to_scene_mat`` (:951).

One kernel (``csrc/stream_train.cu``, ``stream_train_render``) in two
modes, each with its plain PyTorch version beside it:

  * gradients from an upstream cotangent ``g`` of each lane's radiance sum
    (``stream_grads_kernel`` / ``stream_grads_reference``);
  * the fused step: the stream render of every lane's pixel, the
    per-pixel loss and its cotangent, then the reverse
    (``fused_stream_kernel`` / ``fused_stream_reference``).

Both replace ``_stream_grad_kernel`` (``mse=False`` and ``mse=True``).
Their image and walk are ``stream_kernel``'s; their reverse is
``train_kernel``'s, keyed by stream row.

The sphere cotangents leave the kernel as records: each reverse step
writes (stream row, nine cotangents) at a fixed index (lane, sample,
bounce), and ``scatter_records`` adds each row's records in record
order: a stable sort of the rows (``record_order``), then the
segmented sum (``segment_sum_kernel`` / ``segment_sum_reference``, the
same adds in the same order). Memory is O(pixels x samples x depth), no
float atomics, and the gradients are the same bits from run to run. The
camera's scalars and the loss keep the train kernels' block partials and
``train_kernel._reduce_rows``.

``_grads``, ``_fused`` and ``_segment_sum`` pick the kernel for CUDA
tensors and the plain version for CPU tensors; nothing falls back.
Gradients come back in stream row order; ``stream_grads_to_scene_mat``
maps them to scene order through ``perm``.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.camera import CameraConfig, initialize
from . import render_kernel as rk
from . import rng as rtrng
from . import stream_kernel as sk
from . import train_kernel as tk
from .backward import N_CAM
from .stream_kernel import StreamScene

# sorted records per thread in the segmented sum's first pass
# (csrc/stream_train.cu:kChunk)
CHUNK = 256
# The record buffers hold padded x samples x max_depth records of 40
# bytes; above this count (10.7 GB) the wrappers raise.
MAX_RECORDS = 1 << 28

# Launches of the CUDA kernels (the wrappers add one per launch).
LAUNCHES = 0            # stream_train_render, both modes
SEGMENT_LAUNCHES = 0    # segment_sum's two kernels, two per call


def _check(ids, ii, jj, rows, scene_mat, bounds, cam_row, *, block, samples,
           max_depth, rr_start, sample_offset):
    if max_depth > tk.MAX_DEPTH:
        raise ValueError(
            f"max_depth {max_depth} exceeds the train kernels' residual "
            f"stack ({tk.MAX_DEPTH} bounces)")
    if ids.shape[0] * samples * max_depth > MAX_RECORDS:
        raise ValueError(
            f"{ids.shape[0]} lanes x {samples} samples x {max_depth} "
            f"bounces exceed the {MAX_RECORDS} gradient records a call "
            "holds; split the samples (sample_offset windows add up)")
    return sk._check(ids, ii, jj, rows, scene_mat, bounds, cam_row,
                     block=block, samples=samples, max_depth=max_depth,
                     rr_start=rr_start, sample_offset=sample_offset)


# -- the scatter ----------------------------------------------------------------

def record_order(rec_row: torch.Tensor):
    """(keys, src) of the written records (row >= 0), sorted stably by
    row: ``keys`` int32 rows, ``src`` int64 record indices, so each row's
    records stay in record order."""
    src = torch.nonzero(rec_row >= 0).squeeze(1)
    keys = rec_row[src]
    order = torch.argsort(keys, stable=True)
    return keys[order].contiguous(), src[order].contiguous()


def segment_sum_reference(keys, src, vals, n_rows: int) -> torch.Tensor:
    """Plain version of the segmented sum: (n_rows, 9) with row ``k`` the
    sum of ``vals[src[p]]`` over the sorted positions ``p`` whose key is
    ``k``, added as the kernel adds them. Pass 1: within each chunk of
    ``CHUNK`` positions, each run of equal keys in position order; pass
    2: a row's run sums, the one where its span starts and then one at
    each chunk start inside the span, in order."""
    m = keys.shape[0]
    out = torch.zeros((n_rows, tk.GRAD_COLS), dtype=torch.float32,
                      device=keys.device)
    if m == 0:
        return out
    x = vals[src]
    keys = keys.long()
    nc = -(-m // CHUNK)
    starts = torch.arange(nc, device=keys.device) * CHUNK
    part = torch.zeros_like(x)
    acc = run0 = None
    for j in range(CHUNK):
        pos = starts + j
        live = pos < m
        if not bool(live.any()):
            break
        at = pos.clamp(max=m - 1)
        new_run = (torch.ones_like(live) if j == 0
                   else keys[at] != keys[(at - 1).clamp(min=0)])
        acc = x[at] if j == 0 else torch.where(new_run[:, None], x[at],
                                               acc + x[at])
        run0 = at if j == 0 else torch.where(new_run, at, run0)
        nxt = (at + 1).clamp(max=m - 1)
        ends = live & ((j == CHUNK - 1) | (pos + 1 >= m)
                       | (keys[nxt] != keys[at]))
        part[run0[ends]] = acc[ends]
    first = torch.ones(m, dtype=torch.bool, device=keys.device)
    first[1:] = keys[1:] != keys[:-1]
    q = torch.nonzero(first).squeeze(1)
    end = torch.cat([q[1:], torch.tensor([m], device=q.device)])
    v = part[q]
    r = (q // CHUNK + 1) * CHUNK
    while bool((r < end).any()):
        inside = r < end
        v = torch.where(inside[:, None], v + part[r.clamp(max=m - 1)], v)
        r = r + CHUNK
    out[keys[q]] = v
    return out


def segment_sum_kernel(keys, src, vals, n_rows: int) -> torch.Tensor:
    """Launch the segmented-sum kernels (``csrc/stream_train.cu``); same
    contract as ``segment_sum_reference``, the same bits."""
    global SEGMENT_LAUNCHES
    if keys.device.type != "cuda":
        raise ValueError(f"segment_sum_kernel takes CUDA tensors, got "
                         f"{keys.device}")
    if not (keys.dtype == torch.int32 and src.dtype == torch.int64
            and vals.dtype == torch.float32 and vals.dim() == 2
            and vals.shape[1] == tk.GRAD_COLS and keys.is_contiguous()
            and src.is_contiguous() and vals.is_contiguous()
            and keys.shape == src.shape):
        raise ValueError("segment_sum_kernel takes int32 keys, int64 src "
                         "and (records, 9) f32 values, contiguous")
    from . import _build

    launch = _build.function("segment_sum", [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    m = keys.shape[0]
    out = torch.zeros((n_rows, tk.GRAD_COLS), dtype=torch.float32,
                      device=keys.device)
    part = torch.empty((max(m, 1), tk.GRAD_COLS), dtype=torch.float32,
                       device=keys.device)
    tk._raise_on(launch(keys.data_ptr(), src.data_ptr(), vals.data_ptr(), m,
                        part.data_ptr(), out.data_ptr(), tk._stream(keys)),
                 "segment_sum")
    if m:   # chunk_sums_kernel, then segment_sums_kernel
        SEGMENT_LAUNCHES += 2
    return out


def _segment_sum(keys, *args) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if keys.device.type == "cuda":
        return segment_sum_kernel(keys, *args)
    if keys.device.type == "cpu":
        return segment_sum_reference(keys, *args)
    raise ValueError(f"no segmented sum for device {keys.device}")


def scatter_records(rec_row, rec_val, n_rows: int) -> torch.Tensor:
    """(records,) rows (-1: none) and (records, 9) cotangents -> (n_rows,
    9) per-row sums, each row's records added in record order."""
    keys, src = record_order(rec_row)
    return _segment_sum(keys, src, rec_val, n_rows)


# -- the plain versions -------------------------------------------------------

def stream_grads_reference(ids, ii, jj, g_rows, scene_mat, bounds, cam_row, *,
                           block: int, samples: int, max_depth: int,
                           seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                           sample_offset: int = 0):
    """Plain PyTorch version of the kernel's gradient mode:
    ``train_kernel.grad_reference`` with the stream walk as the hit test,
    its records keyed by stream row and summed by
    ``segment_sum_reference``. Returns (d_stream (rows, 16) in stream
    order, d_cam_row (1, 24)); columns 9-15 and 18-23 are zero."""
    rr_start = _check(ids, ii, jj, g_rows, scene_mat, bounds, cam_row,
                      block=block, samples=samples, max_depth=max_depth,
                      rr_start=rr_start, sample_offset=sample_offset)
    dev, padded = ids.device, ids.shape[0]
    rec_row = torch.full((padded, samples, max_depth), -1, dtype=torch.int32,
                         device=dev)
    rec_val = torch.zeros((padded, samples, max_depth, tk.GRAD_COLS),
                          dtype=torch.float32, device=dev)
    dcam = torch.zeros(N_CAM, dtype=torch.float32, device=dev)
    walk = sk._Walk(scene_mat, bounds, block)
    scene = rk.scene_from_matrix(scene_mat)
    cam = rk.unpack_camera(cam_row)
    key = rtrng.key_from_seed(seed)
    chunk = max(rk.PAD, rk._REFERENCE_CHUNK_ELEMS // block // rk.PAD * rk.PAD)
    for lo in range(0, padded, chunk):
        sl = slice(lo, lo + chunk)

        def record(si, b, slot, rows9, sl=sl):
            rec_row[sl, si, b] = slot.to(torch.int32)
            rec_val[sl, si, b] = rows9

        tk._grad_lanes(ids[sl], ii[sl], jj[sl], g_rows[:, sl], scene, cam,
                       key, None, dcam, samples=samples, max_depth=max_depth,
                       rr_start=rr_start, sample_offset=sample_offset,
                       hit_fn=walk, record=record)
    keys, src = record_order(rec_row.reshape(-1))
    d9 = segment_sum_reference(keys, src, rec_val.reshape(-1, tk.GRAD_COLS),
                               scene_mat.shape[0])
    return tk._outputs(d9, dcam)


def fused_stream_reference(ids, ii, jj, target_rows, scene_mat, bounds,
                           cam_row, *, block: int, samples: int,
                           max_depth: int, num_pixels: int,
                           seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                           gamma: bool = False, loss: str = "mse",
                           huber_delta: float = 1.0):
    """Plain PyTorch version of the kernel's fused mode:
    ``stream_reference``'s render, ``train_kernel.loss_and_cotangent``,
    then ``stream_grads_reference`` with that cotangent. Returns (loss sum
    before the weight (), image (3, padded), d_stream, d_cam_row)."""
    _check(ids, ii, jj, target_rows, scene_mat, bounds, cam_row, block=block,
           samples=samples, max_depth=max_depth, rr_start=rr_start,
           sample_offset=0)
    budget = torch.full(ids.shape, float(samples), dtype=torch.float32,
                        device=ids.device)
    acc = sk.stream_reference(ids, ii, jj, budget, scene_mat, bounds, cam_row,
                              block=block, samples=samples,
                              max_depth=max_depth, seed=seed,
                              rr_start=rr_start)
    img, terms, g = tk.loss_and_cotangent(acc, target_rows, ids,
                                          samples=samples, gamma=gamma,
                                          loss=loss, huber_delta=huber_delta,
                                          num_pixels=num_pixels)
    d_stream, d_cam = stream_grads_reference(
        ids, ii, jj, g.contiguous(), scene_mat, bounds, cam_row, block=block,
        samples=samples, max_depth=max_depth, seed=seed, rr_start=rr_start)
    return terms.sum(), img, d_stream, d_cam


# -- the CUDA launcher ----------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_C_ARGTYPES = [
    _P, _P, _P,         # ids, ii, jj
    _P,                 # g or target rows (3, padded)
    _P, _I,             # stream matrix SoA (11, rows), rows
    _P, _I, _I,         # bounds (nb, 8), nb, block
    _P,                 # cam row
    _I, _I, _I,         # padded, samples, max_depth
    _U, _U,             # key words
    _I, _I, _I,         # sample_offset, rr_start (-1 = off), fused
    _I, _I, _I,         # gamma, loss kind, num_pixels
    _F, _F, _F, _F, _F,  # inv_spp, w, two_w, hd, half_hd
    _P,                 # image (3, padded), fused
    _P, _P,             # record rows, record values
    _P, _P,             # camera and loss partials
    _P,                 # cudaStream_t
]


def train_records(ids, ii, jj, rows, scene_mat, bounds, cam_row, *, block,
                  samples, max_depth, seed, rr_start, sample_offset, fused,
                  num_pixels=0, gamma=False, loss="mse", huber_delta=1.0):
    """One launch of ``stream_train_render`` on checked arguments: returns
    (image (3, padded) or a dummy, record rows (records,) int32, record
    values (records, 9), camera partials (blocks, 18), loss partials
    (blocks, 1)). ``scatter_records`` and ``_reduce_rows`` finish them."""
    global LAUNCHES
    from . import _build

    launch = _build.function("stream_train_render", _C_ARGTYPES)
    dev, padded = ids.device, ids.shape[0]
    blocks = padded // rk.PAD
    n_rec = padded * samples * max_depth
    rec_row = torch.full((n_rec,), -1, dtype=torch.int32, device=dev)
    rec_val = torch.empty((n_rec, tk.GRAD_COLS), dtype=torch.float32,
                          device=dev)
    image = torch.empty((3, padded) if fused else (1,), dtype=torch.float32,
                        device=dev)
    cam_part = torch.empty((blocks, N_CAM), dtype=torch.float32, device=dev)
    loss_part = torch.empty((blocks, 1), dtype=torch.float32, device=dev)
    scene = sk.soa(scene_mat)
    k = tk.loss_constants(samples, max(num_pixels, 1), huber_delta)
    k0, k1 = rtrng.key_from_seed(seed)
    err = launch(ids.data_ptr(), ii.data_ptr(), jj.data_ptr(),
                 rows.data_ptr(), scene.data_ptr(),
                 scene_mat.shape[0], bounds.data_ptr(), bounds.shape[0],
                 block, cam_row.data_ptr(), padded, samples, max_depth, k0,
                 k1, sample_offset, -1 if rr_start is None else rr_start,
                 int(fused), int(gamma), tk.LOSSES.index(loss), num_pixels,
                 k["inv_spp"], k["w"], k["two_w"], k["hd"], k["half_hd"],
                 image.data_ptr(), rec_row.data_ptr(), rec_val.data_ptr(),
                 cam_part.data_ptr(), loss_part.data_ptr(), tk._stream(ids))
    tk._raise_on(err, "stream_train_render")
    LAUNCHES += 1
    return image, rec_row, rec_val, cam_part, loss_part


def _launch(ids, ii, jj, rows, scene_mat, bounds, cam_row, **kw):
    image, rec_row, rec_val, cam_part, loss_part = train_records(
        ids, ii, jj, rows, scene_mat, bounds, cam_row, **kw)
    d9 = scatter_records(rec_row, rec_val, scene_mat.shape[0])
    d_stream, d_cam = tk._outputs(d9, tk._reduce_rows(cam_part))
    return image, loss_part, d_stream, d_cam


def stream_grads_kernel(ids, ii, jj, g_rows, scene_mat, bounds, cam_row, *,
                        block: int, samples: int, max_depth: int,
                        seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                        sample_offset: int = 0):
    """Launch the kernel's gradient mode; same contract as
    ``stream_grads_reference``. Launches on the current stream."""
    tk._cuda_only(ids, "stream_grads_kernel")
    rr_start = _check(ids, ii, jj, g_rows, scene_mat, bounds, cam_row,
                      block=block, samples=samples, max_depth=max_depth,
                      rr_start=rr_start, sample_offset=sample_offset)
    _, _, d_stream, d_cam = _launch(
        ids, ii, jj, g_rows, scene_mat, bounds, cam_row, block=block,
        samples=samples, max_depth=max_depth, seed=seed, rr_start=rr_start,
        sample_offset=sample_offset, fused=False)
    return d_stream, d_cam


def fused_stream_kernel(ids, ii, jj, target_rows, scene_mat, bounds, cam_row,
                        *, block: int, samples: int, max_depth: int,
                        num_pixels: int, seed: int = rtrng.DEFAULT_SEED,
                        rr_start=None, gamma: bool = False, loss: str = "mse",
                        huber_delta: float = 1.0):
    """Launch the kernel's fused mode; same contract as
    ``fused_stream_reference``."""
    tk._cuda_only(ids, "fused_stream_kernel")
    if loss not in tk.LOSSES:
        raise ValueError(f"unknown loss {loss!r}; one of {tk.LOSSES}")
    rr_start = _check(ids, ii, jj, target_rows, scene_mat, bounds, cam_row,
                      block=block, samples=samples, max_depth=max_depth,
                      rr_start=rr_start, sample_offset=0)
    image, loss_part, d_stream, d_cam = _launch(
        ids, ii, jj, target_rows, scene_mat, bounds, cam_row, block=block,
        samples=samples, max_depth=max_depth, seed=seed, rr_start=rr_start,
        sample_offset=0, fused=True, num_pixels=num_pixels, gamma=gamma,
        loss=loss, huber_delta=huber_delta)
    return tk._reduce_rows(loss_part)[0], image, d_stream, d_cam


def _grads(ids, *args, **kw):
    """The gradient mode for CUDA tensors, its plain version for CPU."""
    if ids.device.type == "cuda":
        return stream_grads_kernel(ids, *args, **kw)
    if ids.device.type == "cpu":
        return stream_grads_reference(ids, *args, **kw)
    raise ValueError(f"no stream gradient implementation for {ids.device}")


def _fused(ids, *args, **kw):
    """The fused mode for CUDA tensors, its plain version for CPU."""
    if ids.device.type == "cuda":
        return fused_stream_kernel(ids, *args, **kw)
    if ids.device.type == "cpu":
        return fused_stream_reference(ids, *args, **kw)
    raise ValueError(f"no fused stream step for device {ids.device}")


# -- entry points -------------------------------------------------------------

def _lanes(stream: StreamScene, cam_cfg, img_width, img_height,
           samples_per_pixel, sample_offset, pixel_order):
    dev = stream.scene_mat.device
    cam_row = rk.pack_camera(initialize(cam_cfg, img_width, img_height)).to(dev)
    ids, ii, jj, _ = rk._lane_setup(img_width, img_height, pixel_order,
                                    samples_per_pixel, sample_offset, None,
                                    dev)
    return ids, ii, jj, cam_row


def render_stream_grads(stream: StreamScene, cam_cfg: CameraConfig, g_acc,
                        img_width: int, img_height: int,
                        samples_per_pixel: int, max_depth: int, *,
                        seed: int = rtrng.DEFAULT_SEED, dtype=torch.float32,
                        sample_offset: int = 0, pixel_order=None, mesh=None,
                        rr_start=None):
    """Cotangents for an upstream ``g_acc`` (H, W, 3) in the accumulated
    radiance domain (before 1/spp): (d_stream (rows, 16) in stream row
    order, d_cam_row (1, 24)). Calls over disjoint ``sample_offset``
    windows add up; ``pixel_order`` changes speed only. The TPU
    schedule's keywords (``ray_tile``, ``lane_group``, ``sweep``,
    ``window``, ``pixels_per_lane``, ``park``, ``acc``) have no
    counterpart."""
    tk.refuse_unported(mesh, dtype)
    ids, ii, jj, cam_row = _lanes(stream, cam_cfg, img_width, img_height,
                                  samples_per_pixel, sample_offset,
                                  pixel_order)
    rows = tk._lane_rows(g_acc, ids, img_width * img_height)
    return _grads(ids, ii, jj, rows, stream.scene_mat, stream.bounds,
                  cam_row, block=stream.block, samples=samples_per_pixel,
                  max_depth=max_depth, seed=seed, rr_start=rr_start,
                  sample_offset=sample_offset)


def mse_train_stream(stream: StreamScene, cam_cfg: CameraConfig, target,
                     img_width: int, img_height: int, samples_per_pixel: int,
                     max_depth: int, *, seed: int = rtrng.DEFAULT_SEED,
                     dtype=torch.float32, gamma: bool = False,
                     pixel_order=None, mesh=None, rr_start=None,
                     loss: str = "mse", huber_delta: float = 1.0):
    """The fused stream step: (loss, d_stream (rows, 16) in stream order,
    d_cam_row (1, 24)) against a target (H, W, 3), from one launch. The
    loss ('mse' | 'l1' | 'huber' | 'relmse') is a mean over pixels and
    channels of the image in linear radiance (``gamma=False``, the JAX
    package's only mode) or after gamma 2. The TPU schedule's keywords
    have no counterpart."""
    tk.refuse_unported(mesh, dtype)
    ids, ii, jj, cam_row = _lanes(stream, cam_cfg, img_width, img_height,
                                  samples_per_pixel, 0, pixel_order)
    num_pixels = img_width * img_height
    rows = tk._lane_rows(target, ids, num_pixels)
    total, _img, d_stream, d_cam = _fused(
        ids, ii, jj, rows, stream.scene_mat, stream.bounds, cam_row,
        block=stream.block, samples=samples_per_pixel, max_depth=max_depth,
        num_pixels=num_pixels, seed=seed, rr_start=rr_start, gamma=gamma,
        loss=loss, huber_delta=huber_delta)
    w = tk.loss_constants(samples_per_pixel, num_pixels, huber_delta)["w"]
    return total * w, d_stream, d_cam


def stream_grads_to_scene_mat(d_stream: torch.Tensor, stream: StreamScene,
                              n_slots: int) -> torch.Tensor:
    """Stream-order cotangents (rows, 16) -> scene slot order (n_slots,
    16) through ``perm``; inactive slots get zero."""
    out = torch.zeros((n_slots, rk.NUM_COLS), dtype=d_stream.dtype,
                      device=d_stream.device)
    out[stream.perm.long()] = d_stream[:stream.perm.shape[0]]
    return out
