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

The sphere cotangents leave the kernel as records: the kernel parks the
state entering each bounce in the record buffers, and each reverse step
overwrites its entry with (stream row, nine cotangents), at the fixed
index ((sample, bounce), lane). ``scatter_records`` adds each row's
records in record order: a stable sort of every record by its row, the
unwritten ones keyed past the last row so that they sort last
(``record_order``; the sort needs no count from the card, so the host
does not wait for the kernel), then the segmented sum
(``segment_sum_kernel`` / ``segment_sum_reference``, the same adds in the
same association: tiles of ``TILE`` sorted records) into one row more,
which is dropped. Memory is O(pixels x samples x depth), no float
atomics, and the gradients are the same bits from run to run. The
camera's scalars and the loss keep the train kernels' block partials and
``kernel_io.reduce_rows``. ``walk_counts`` runs the fused mode's walk
alone and counts its work.

A call's records take 40 bytes each, lanes x samples x max_depth of them
(24.6 GB at 640x384, 100 spp and 25 bounces), and their sort 36 bytes
more. ``plan_records`` splits a call into windows whose records and sort
fit ``RECORD_BUDGET``: windows of samples
(``sample_offset`` windows add up) and, where one sample of every lane
does not fit, chunks of lanes (lanes are independent). The gradient mode
launches once a window and adds the windows' cotangents in the plan's
order; its plain version takes the same windows. The fused mode needs
every sample of a pixel before its loss's cotangent exists, so a plan of
more than one window renders the image on the stream kernel, forms the
cotangent with ``train_kernel.loss_and_cotangent`` and runs the gradient
windows; one window is the single fused launch. ``budget`` is a keyword
for tests, not a user's knob.

``_grads``, ``_fused`` and ``_segment_sum`` (``kernel_io.by_device``)
pick the kernel for CUDA tensors and the plain version for CPU tensors;
nothing falls back.
Gradients come back in stream row order; ``stream_grads_to_scene_mat``
maps them to scene order through ``perm``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..models.camera import CameraConfig
from ..parallel import mesh as meshlib
from ..utils import trace
from . import kernel_io as kio
from . import rng as rtrng
from . import stream_kernel as sk
from . import train_kernel as tk
from .backward import N_CAM
from .kernel_io import GRAD_COLS, PAD, WARP
from .stream_kernel import StreamScene

# sorted records per tile of the segmented sum (csrc/stream_train.cu:kTile,
# 32 warps of 32, one record a thread); the association depends on it alone
TILE = 1024
# The record buffers hold lanes x samples x max_depth records of 40 bytes
# (a row and nine floats), and their sort (record_order, every record)
# SORT_BYTES a record more while it runs: the int32 keys, torch.sort's int32
# keys and int64 indices out, and the radix sort's int64 index input and
# int32/int64 alternate buffers. A launch's records and their sort take at
# most RECORD_BUDGET bytes (plan_records, PLAN_BYTES a record), as the train
# kernels' park (train_kernel.PARK_BUDGET).
RECORD_BUDGET = 2 << 30
RECORD_BYTES = 4 + 4 * GRAD_COLS
SORT_BYTES = 4 + 4 + 8 + 8 + 12
PLAN_BYTES = RECORD_BYTES + SORT_BYTES

# The wrappers count their launches (utils/trace.py): launch.stream_train
# (stream_train_render in both modes, stream_walk_counts) and
# launch.stream_segment_sum (segment_sum's two kernels, two per call); each
# walk launch also counts its table launch and rows (stream_kernel.count_walk).


class RecordWindow(NamedTuple):
    """One launch's share of a call: lanes [lane0, lane0 + lanes) over
    samples [sample0, sample0 + samples) of the call's window."""
    lane0: int
    lanes: int
    sample0: int
    samples: int


def plan_records(lanes: int, samples: int, max_depth: int,
                 budget: int = RECORD_BUDGET) -> list:
    """The windows of a call over ``lanes`` lanes (a multiple of ``PAD``),
    in the order their cotangents are added: each (lane, sample) falls in
    exactly one, and one window's records and their sort (lanes x samples
    x max_depth x ``PLAN_BYTES``) take at most ``budget`` bytes. Windows
    of whole samples of every lane where one sample fits, as many samples
    each as fit; else one sample at a time in chunks of lanes (multiples
    of ``PAD``), the chunks of a sample in lane order."""
    if lanes <= 0 or lanes % PAD:
        raise ValueError(f"lanes must be a positive multiple of {PAD}")
    lane_bytes = max_depth * PLAN_BYTES              # one sample of a lane
    if lanes * lane_bytes <= budget:
        per = min(samples, budget // (lanes * lane_bytes))
        return [RecordWindow(0, lanes, s0, min(per, samples - s0))
                for s0 in range(0, samples, per)]
    chunk = budget // lane_bytes // PAD * PAD
    if chunk == 0:
        raise ValueError(f"one sample of {PAD} lanes at depth {max_depth} "
                         f"needs {PAD * lane_bytes} bytes of records and "
                         f"their sort, "
                         f"above the budget of {budget}")
    return [RecordWindow(l0, min(chunk, lanes - l0), s0, 1)
            for s0 in range(samples) for l0 in range(0, lanes, chunk)]


def _windows(ids, ii, jj, rows, plan):
    """Each window of ``plan`` with its lanes' inputs: (window, ids, ii,
    jj, rows); one window of every lane passes the tensors as they are."""
    for w in plan:
        sl = slice(w.lane0, w.lane0 + w.lanes)
        if w.lanes == ids.shape[0]:
            yield w, ids, ii, jj, rows
        else:
            yield w, ids[sl], ii[sl], jj[sl], rows[:, sl].contiguous()


# -- the scatter ----------------------------------------------------------------

def record_order(rec_row: torch.Tensor, n_rows: int):
    """(keys, src) of every record, sorted stably by row: ``keys`` int32,
    each written record's row (row >= 0) and ``n_rows`` for the others,
    ``src`` int64 record indices. Each row's records stay in record order
    and the unwritten ones come last, so the written records take the
    places a sort of them alone gives them."""
    keys = torch.where(rec_row >= 0, rec_row, n_rows)
    keys, src = torch.sort(keys, stable=True)
    return keys.contiguous(), src.contiguous()


def _warp_scan(f, v):
    """The kernel's segmented inclusive scan over warps of 32 lanes: (rows,
    32) head flags and (rows, 32, 9) values; in steps of 1, 2, 4, 8, 16
    lanes, lane l takes (f, v) of lane l - step on the left: (f_l-step |
    f_l, f_l ? v_l : v_l-step + v_l)."""
    lane = torch.arange(WARP, device=f.device)
    step = 1
    while step < WARP:
        fp = torch.zeros_like(f)
        fp[:, step:] = f[:, :-step]
        vp = torch.zeros_like(v)
        vp[:, step:] = v[:, :-step]
        on = lane >= step
        v = torch.where((on & ~f)[..., None], vp + v, v)
        f = f | (on & fp)
        step *= 2
    return f, v


def segment_sum_reference(keys, src, vals, n_rows: int) -> torch.Tensor:
    """Plain version of the segmented sum: (n_rows, 9) with row ``k`` the
    sum of ``vals[src[p]]`` over the sorted positions ``p`` whose key is
    ``k``, added as the kernels add them. Per tile of ``TILE`` positions,
    a segmented inclusive scan (head flags at run starts and the tile's
    first position) in each warp of 32, then over the tile's 32 warp
    totals, each position adding its warp's exclusive prefix on the left;
    a run inside a tile is its last position's sum. A run that crosses
    tile edges adds its partials (its sum in each tile, in tile order)
    lane by lane over 32 lanes (partial i to lane i % 32), then in a
    halving tree (lanes l and l + 16, then l + 8, ...)."""
    m, dev = keys.shape[0], keys.device
    out = torch.zeros((n_rows, GRAD_COLS), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    tiles = -(-m // TILE)
    size = tiles * TILE
    k = torch.full((size,), -1, dtype=torch.int64, device=dev)
    k[:m] = keys
    x = torch.zeros((size, GRAD_COLS), dtype=torch.float32, device=dev)
    x[:m] = vals[src]
    pos = torch.arange(size, device=dev)
    tid = pos % TILE
    valid = pos < m
    prev = torch.cat([k.new_full((1,), -1), k[:-1]])
    f, v = _warp_scan((valid & ((tid == 0) | (k != prev))).view(-1, WARP),
                      x.view(-1, WARP, GRAD_COLS))
    _, tot = _warp_scan(f[:, -1].reshape(tiles, WARP),
                        v[:, -1].reshape(tiles, WARP, GRAD_COLS))
    carry = torch.zeros_like(tot)           # warp w adds warps < w's scan
    carry[:, 1:] = tot[:, :-1]
    later = (torch.arange(WARP, device=dev) > 0)[:, None]
    f = f.view(tiles, WARP, WARP)
    v = v.view(tiles, WARP, WARP, GRAD_COLS)
    v = torch.where((later & ~f)[..., None], carry[:, :, None] + v, v)
    v = v.reshape(size, GRAD_COLS)
    nxt = torch.cat([k[1:], k.new_full((1,), -1)])
    last = valid & ((tid == TILE - 1) | (nxt != k))
    base = pos - tid
    before = (base > 0) & (k[base] == k) & (k[(base - 1).clamp(min=0)] == k)
    after = (tid == TILE - 1) & (pos + 1 < m) & (nxt == k)
    inner = last & ~before & ~after
    out[k[inner]] = v[inner]
    head = torch.zeros((tiles, GRAD_COLS), dtype=torch.float32, device=dev)
    tail = torch.zeros_like(head)
    head[pos[last & before] // TILE] = v[last & before]
    tail[pos[after] // TILE] = v[after]
    # runs that cross out of tile t and start in it
    t = torch.arange(tiles, device=dev)
    end = torch.clamp((t + 1) * TILE, max=m) - 1
    key_t = k[end]
    cross = (end + 1 < m) & (k[(end + 1).clamp(max=m - 1)] == key_t)
    starts = ~((t > 0) & (k[(t * TILE - 1).clamp(min=0)] == key_t))
    own = cross & starts
    if bool(own.any()):
        ot, okey = t[own], key_t[own]
        tb = (torch.searchsorted(k[:m], okey, right=True) - 1) // TILE
        n = tb - ot + 1
        width = -(-int(n.max()) // WARP) * WARP
        j = torch.arange(width, device=dev)
        parts = torch.where((j == 0)[None, :, None], tail[ot][:, None],
                            head[(ot[:, None] + j).clamp(max=tiles - 1)])
        live = j[None, :] < n[:, None]
        acc = torch.zeros((ot.shape[0], WARP, GRAD_COLS),
                          dtype=torch.float32, device=dev)
        for r in range(0, width, WARP):
            sl = slice(r, r + WARP)
            acc = torch.where(live[:, sl, None], acc + parts[:, sl], acc)
        off = WARP // 2
        while off:
            acc[:, :off] = acc[:, :off] + acc[:, off:2 * off]
            off //= 2
        out[okey] = acc[:, 0]
    return out


@trace.spanned("rt.launch.stream_segment_sum")
def segment_sum_kernel(keys, src, vals, n_rows: int) -> torch.Tensor:
    """Launch the segmented-sum kernels (``csrc/stream_train.cu``); same
    contract as ``segment_sum_reference``, the same bits."""
    launch = kio.entry("segment_sum", [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p], keys.device)
    if not (keys.dtype == torch.int32 and src.dtype == torch.int64
            and vals.dtype == torch.float32 and vals.dim() == 2
            and vals.shape[1] == GRAD_COLS and keys.is_contiguous()
            and src.is_contiguous() and vals.is_contiguous()
            and keys.shape == src.shape):
        raise ValueError("segment_sum_kernel takes int32 keys, int64 src "
                         "and (records, 9) f32 values, contiguous")
    m = keys.shape[0]
    out = torch.zeros((n_rows, GRAD_COLS), dtype=torch.float32,
                      device=keys.device)
    # the head, then the tail partials of each tile
    part = torch.empty((2 * max(-(-m // TILE), 1), GRAD_COLS),
                       dtype=torch.float32, device=keys.device)
    launch(keys.data_ptr(), src.data_ptr(), vals.data_ptr(), m,
           part.data_ptr(), out.data_ptr())
    if m:   # tile_sums_kernel, then cross_sums_kernel
        trace.count("launch.stream_segment_sum", 2)
    return out


_segment_sum = kio.by_device(segment_sum_kernel, segment_sum_reference)


@trace.spanned("rt.records")
def scatter_records(rec_row, rec_val, n_rows: int) -> torch.Tensor:
    """(records,) rows (-1: none) and (records, 9) cotangents -> (n_rows,
    9) per-row sums, each row's records added in record order (the
    unwritten records' row ``n_rows`` summed and dropped)."""
    keys, src = record_order(rec_row, n_rows)
    return _segment_sum(keys, src, rec_val, n_rows + 1)[:n_rows]


# -- the plain versions -------------------------------------------------------

def stream_grads_reference(ids, ii, jj, g_rows, scene_mat, bounds, cam_row, *,
                           block: int, samples: int, max_depth: int,
                           seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                           sample_offset: int = 0,
                           budget: int = RECORD_BUDGET):
    """Plain PyTorch version of the kernel's gradient mode:
    ``train_kernel.grad_reference`` with the stream walk as the hit test,
    its records keyed by stream row and summed by
    ``segment_sum_reference``, window by window of
    ``plan_records(..., budget)``, the windows' sums added in the plan's
    order. Returns (d_stream (rows, 16) in stream order, d_cam_row (1,
    24)); columns 9-15 and 18-23 are zero."""
    rr_start = sk.check_args(ids, ii, jj, g_rows, scene_mat, bounds, cam_row,
                             block=block, samples=samples,
                             max_depth=max_depth, rr_start=rr_start,
                             sample_offset=sample_offset)
    d9 = dcam = None
    for w, *lanes in _windows(ids, ii, jj, g_rows,
                              plan_records(ids.shape[0], samples, max_depth,
                                           budget)):
        d9_w, dcam_w = _grads_window(
            *lanes, scene_mat, bounds, cam_row, block=block,
            samples=w.samples, max_depth=max_depth, seed=seed,
            rr_start=rr_start, sample_offset=sample_offset + w.sample0)
        d9 = d9_w if d9 is None else d9 + d9_w
        dcam = dcam_w if dcam is None else dcam + dcam_w
    return kio.grad_outputs(d9, dcam)


def _grads_window(ids, ii, jj, g_rows, scene_mat, bounds, cam_row, *, block,
                  samples, max_depth, seed, rr_start, sample_offset):
    """The plain gradient mode over one window: (d9 (rows, 9), dcam
    (18,))."""
    dev, padded = ids.device, ids.shape[0]
    rec_row = torch.full((samples, max_depth, padded), -1, dtype=torch.int32,
                         device=dev)
    rec_val = torch.zeros((samples, max_depth, padded, GRAD_COLS),
                          dtype=torch.float32, device=dev)
    dcam = torch.zeros(N_CAM, dtype=torch.float32, device=dev)
    walk = sk.Walk(scene_mat, bounds, block)
    scene = kio.scene_from_matrix(scene_mat)
    cam = kio.unpack_camera(cam_row)
    key = rtrng.key_from_seed(seed)
    chunk = kio.reference_chunk(block)
    for lo in range(0, padded, chunk):
        sl = slice(lo, lo + chunk)

        def record(si, b, slot, rows9, sl=sl):
            rec_row[si, b, sl] = slot.to(torch.int32)
            rec_val[si, b, sl] = rows9

        tk.grad_lanes(ids[sl], ii[sl], jj[sl], g_rows[:, sl], scene, cam,
                      key, None, dcam, samples=samples, max_depth=max_depth,
                      rr_start=rr_start, sample_offset=sample_offset,
                      hit_fn=walk, record=record)
    n_rows = scene_mat.shape[0]
    keys, src = record_order(rec_row.reshape(-1), n_rows)
    d9 = segment_sum_reference(keys, src, rec_val.reshape(-1, GRAD_COLS),
                               n_rows + 1)[:n_rows]
    return d9, dcam


def fused_stream_reference(ids, ii, jj, target_rows, scene_mat, bounds,
                           cam_row, *, block: int, samples: int,
                           max_depth: int, num_pixels: int,
                           seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                           gamma: bool = False, loss: str = "mse",
                           huber_delta: float = 1.0,
                           budget: int = RECORD_BUDGET):
    """Plain PyTorch version of the kernel's fused mode:
    ``stream_reference``'s render, ``train_kernel.loss_and_cotangent``,
    then ``stream_grads_reference`` with that cotangent (in the windows of
    ``budget``). Returns (loss sum before the weight (), image (3, padded),
    d_stream, d_cam_row)."""
    sk.check_args(ids, ii, jj, target_rows, scene_mat, bounds, cam_row,
                  block=block, samples=samples, max_depth=max_depth,
                  rr_start=rr_start)
    full = torch.full(ids.shape, float(samples), dtype=torch.float32,
                      device=ids.device)
    acc = sk.stream_reference(ids, ii, jj, full, scene_mat, bounds, cam_row,
                              block=block, samples=samples,
                              max_depth=max_depth, seed=seed,
                              rr_start=rr_start)
    img, terms, g = tk.loss_and_cotangent(acc, target_rows, ids,
                                          samples=samples, gamma=gamma,
                                          loss=loss, huber_delta=huber_delta,
                                          num_pixels=num_pixels)
    d_stream, d_cam = stream_grads_reference(
        ids, ii, jj, g.contiguous(), scene_mat, bounds, cam_row, block=block,
        samples=samples, max_depth=max_depth, seed=seed, rr_start=rr_start,
        budget=budget)
    return terms.sum(), img, d_stream, d_cam


# -- the CUDA launcher ----------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_C_ARGTYPES = [
    _P, _P, _P,         # ids, ii, jj
    _P,                 # g or target rows (3, padded)
    _P, _I,             # stream matrix SoA (11, rows), rows
    _P,                 # the walk's tables (scan_buffer), written by it
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
]
_COUNT_ARGTYPES = [
    _P, _P, _P,         # ids, ii, jj
    _P, _I, _P,         # stream matrix SoA, rows, scan table
    _P, _I, _I,         # bounds, nb, block
    _P,                 # cam row
    _I, _I, _I,         # padded, samples, max_depth
    _U, _U,             # key words
    _P, _P, _P,         # opened per lane, walked and tested per warp
]


@trace.spanned("rt.launch.stream_train")
def train_records(ids, ii, jj, rows, scene_mat, bounds, cam_row, *, block,
                  samples, max_depth, seed, rr_start, sample_offset, fused,
                  num_pixels=0, gamma=False, loss="mse", huber_delta=1.0):
    """One launch of ``stream_train_render`` on checked arguments: returns
    (image (3, padded) or a dummy, record rows (records,) int32, record
    values (records, 9), camera partials (blocks, 18), loss partials
    (blocks, 1)). Record ((sample, bounce), lane) is at index (sample *
    max_depth + bounce) * padded + lane. ``scatter_records`` and
    ``kernel_io.reduce_rows`` finish them."""
    launch = kio.entry("stream_train_render", _C_ARGTYPES, ids.device)
    dev, padded = ids.device, ids.shape[0]
    blocks = padded // PAD
    n_rec = padded * samples * max_depth
    rec_row = torch.full((n_rec,), -1, dtype=torch.int32, device=dev)
    rec_val = torch.empty((n_rec, GRAD_COLS), dtype=torch.float32,
                          device=dev)
    image = torch.empty((3, padded) if fused else (1,), dtype=torch.float32,
                        device=dev)
    cam_part = torch.empty((blocks, N_CAM), dtype=torch.float32, device=dev)
    loss_part = torch.empty((blocks, 1), dtype=torch.float32, device=dev)
    scene, scan = kio.soa(scene_mat), sk.scan_buffer(scene_mat, block)
    k = tk.loss_constants(samples, max(num_pixels, 1), huber_delta)
    k0, k1 = rtrng.key_from_seed(seed)
    launch(ids.data_ptr(), ii.data_ptr(), jj.data_ptr(), rows.data_ptr(),
           scene.data_ptr(), scene_mat.shape[0], scan.data_ptr(),
           bounds.data_ptr(), bounds.shape[0], block, cam_row.data_ptr(),
           padded, samples, max_depth, k0, k1, sample_offset,
           -1 if rr_start is None else rr_start, int(fused), int(gamma),
           tk.LOSSES.index(loss), num_pixels, k["inv_spp"], k["w"],
           k["two_w"], k["hd"], k["half_hd"], image.data_ptr(),
           rec_row.data_ptr(), rec_val.data_ptr(), cam_part.data_ptr(),
           loss_part.data_ptr())
    trace.count("launch.stream_train")
    sk.count_walk(bounds, block)
    return image, rec_row, rec_val, cam_part, loss_part


def walk_counts(ids, ii, jj, scene_mat, bounds, cam_row, *, block: int,
                samples: int, max_depth: int):
    """The fused mode's walk alone on the card (``stream_walk_counts``),
    with the train step's seed and estimator (``DEFAULT_SEED``, no
    Russian roulette), counting its work as the stream kernel's count
    mode does: (blocks opened per lane (padded,) int32; blocks walked per
    warp (padded // 32,) int32, the union of its 32 lanes' opened blocks;
    rows tested per warp (padded // 32,) int32)."""
    launch = kio.entry("stream_walk_counts", _COUNT_ARGTYPES, ids.device)
    sk.check_args(ids, ii, jj, None, scene_mat, bounds, cam_row, block=block,
                  samples=samples, max_depth=max_depth)
    padded = ids.shape[0]
    opened = torch.empty((padded,), dtype=torch.int32, device=ids.device)
    fetched = torch.empty((padded // 32,), dtype=torch.int32,
                          device=ids.device)
    tested = torch.empty_like(fetched)
    scene, scan = kio.soa(scene_mat), sk.scan_buffer(scene_mat, block)
    k0, k1 = rtrng.key_from_seed(rtrng.DEFAULT_SEED)
    launch(ids.data_ptr(), ii.data_ptr(), jj.data_ptr(), scene.data_ptr(),
           scene_mat.shape[0], scan.data_ptr(), bounds.data_ptr(),
           bounds.shape[0], block, cam_row.data_ptr(), padded, samples,
           max_depth, k0, k1, opened.data_ptr(), fetched.data_ptr(),
           tested.data_ptr())
    trace.count("launch.stream_train")
    sk.count_walk(bounds, block)
    return opened, fetched, tested


def _launch(ids, ii, jj, rows, scene_mat, bounds, cam_row, **kw):
    image, rec_row, rec_val, cam_part, loss_part = train_records(
        ids, ii, jj, rows, scene_mat, bounds, cam_row, **kw)
    d9 = scatter_records(rec_row, rec_val, scene_mat.shape[0])
    d_stream, d_cam = kio.grad_outputs(d9, kio.reduce_rows(cam_part))
    return image, loss_part, d_stream, d_cam


def stream_grads_kernel(ids, ii, jj, g_rows, scene_mat, bounds, cam_row, *,
                        block: int, samples: int, max_depth: int,
                        seed: int = rtrng.DEFAULT_SEED, rr_start=None,
                        sample_offset: int = 0, budget: int = RECORD_BUDGET):
    """Launch the kernel's gradient mode, once a window of
    ``plan_records``; same contract as ``stream_grads_reference``.
    Launches on the current stream without synchronising."""
    rr_start = sk.check_args(ids, ii, jj, g_rows, scene_mat, bounds, cam_row,
                             block=block, samples=samples,
                             max_depth=max_depth, rr_start=rr_start,
                             sample_offset=sample_offset)
    d_stream = d_cam = None
    for w, *lanes in _windows(ids, ii, jj, g_rows,
                              plan_records(ids.shape[0], samples, max_depth,
                                           budget)):
        _, _, ds, dc = _launch(
            *lanes, scene_mat, bounds, cam_row, block=block,
            samples=w.samples, max_depth=max_depth, seed=seed,
            rr_start=rr_start, sample_offset=sample_offset + w.sample0,
            fused=False)
        d_stream = ds if d_stream is None else d_stream + ds
        d_cam = dc if d_cam is None else d_cam + dc
    return d_stream, d_cam


@trace.spanned("rt.launch.fused_stream")
def fused_stream_kernel(ids, ii, jj, target_rows, scene_mat, bounds, cam_row,
                        *, block: int, samples: int, max_depth: int,
                        num_pixels: int, seed: int = rtrng.DEFAULT_SEED,
                        rr_start=None, gamma: bool = False, loss: str = "mse",
                        huber_delta: float = 1.0,
                        budget: int = RECORD_BUDGET):
    """Launch the kernel's fused mode; same contract as
    ``fused_stream_reference``. Where ``plan_records`` gives more than one
    window: the stream kernel's render, the loss block on the card
    (``train_kernel.loss_and_cotangent``, its loss summed in the fused
    launch's order) and the gradient mode window by window."""
    if loss not in tk.LOSSES:
        raise ValueError(f"unknown loss {loss!r}; one of {tk.LOSSES}")
    rr_start = sk.check_args(ids, ii, jj, target_rows, scene_mat, bounds,
                             cam_row, block=block, samples=samples,
                             max_depth=max_depth, rr_start=rr_start)
    if len(plan_records(ids.shape[0], samples, max_depth, budget)) > 1:
        full = torch.full(ids.shape, float(samples), dtype=torch.float32,
                          device=ids.device)
        acc = sk.stream_kernel(ids, ii, jj, full, scene_mat, bounds, cam_row,
                               block=block, samples=samples,
                               max_depth=max_depth, seed=seed,
                               rr_start=rr_start)
        img, terms, g = tk.loss_and_cotangent(
            acc, target_rows, ids, samples=samples, gamma=gamma, loss=loss,
            huber_delta=huber_delta, num_pixels=num_pixels)
        d_stream, d_cam = stream_grads_kernel(
            ids, ii, jj, g.contiguous(), scene_mat, bounds, cam_row,
            block=block, samples=samples, max_depth=max_depth, seed=seed,
            rr_start=rr_start, budget=budget)
        return _block_sum(terms), img, d_stream, d_cam
    image, loss_part, d_stream, d_cam = _launch(
        ids, ii, jj, target_rows, scene_mat, bounds, cam_row, block=block,
        samples=samples, max_depth=max_depth, seed=seed, rr_start=rr_start,
        sample_offset=0, fused=True, num_pixels=num_pixels, gamma=gamma,
        loss=loss, huber_delta=huber_delta)
    return kio.reduce_rows(loss_part)[0], image, d_stream, d_cam


def _block_sum(terms: torch.Tensor) -> torch.Tensor:
    """The lanes' loss terms (padded,) summed as the fused launch sums
    them: a halving tree over each block of ``PAD`` lanes (``block_tree``),
    then the block partials by ``kernel_io.reduce_rows``."""
    x = terms.view(-1, PAD)
    half = PAD // 2
    while half:
        x = x[:, :half] + x[:, half:2 * half]
        half //= 2
    return kio.reduce_rows(x.contiguous())[0]


_grads = kio.by_device(stream_grads_kernel, stream_grads_reference)
_fused = kio.by_device(fused_stream_kernel, fused_stream_reference)


# -- entry points -------------------------------------------------------------

def _lanes(stream: StreamScene, cam_cfg, img_width, img_height,
           samples_per_pixel, sample_offset, pixel_order, mesh, img):
    """The lanes of every rank of ``mesh`` with ``img``'s lane rows, then
    this rank's slice of each: (ids, ii, jj, rows, cam_row)."""
    dev = stream.scene_mat.device
    cam_row = kio.camera_row(cam_cfg, img_width, img_height, dev)
    ids, ii, jj, _ = kio.lane_setup(img_width, img_height, pixel_order,
                                    samples_per_pixel, sample_offset, None,
                                    dev, mesh)
    rows = kio.lane_rows(img, ids, img_width * img_height)
    return (*kio.shard(mesh, ids, ii, jj, rows), cam_row)


def render_stream_grads(stream: StreamScene, cam_cfg: CameraConfig, g_acc,
                        img_width: int, img_height: int,
                        samples_per_pixel: int, max_depth: int, *,
                        seed: int = rtrng.DEFAULT_SEED, dtype=torch.float32,
                        sample_offset: int = 0, pixel_order=None, mesh=None,
                        rr_start=None, budget: int = RECORD_BUDGET):
    """Cotangents for an upstream ``g_acc`` (H, W, 3) in the accumulated
    radiance domain (before 1/spp): (d_stream (rows, 16) in stream row
    order, d_cam_row (1, 24)). Calls over disjoint ``sample_offset``
    windows add up; ``pixel_order`` changes speed only. The TPU
    schedule's keywords (``ray_tile``, ``lane_group``, ``sweep``,
    ``window``, ``pixels_per_lane``, ``park``, ``acc``) have no
    counterpart. ``mesh``: each rank takes its slice of the lanes, and the
    cotangents are summed over the ranks (one ``all_reduce``). The records
    go in windows of ``plan_records(..., budget)`` (each rank plans its own
    lanes)."""
    tk.refuse_unported(dtype)
    ids, ii, jj, rows, cam_row = _lanes(stream, cam_cfg, img_width,
                                        img_height, samples_per_pixel,
                                        sample_offset, pixel_order, mesh,
                                        g_acc)
    d_stream, d_cam = _grads(ids, ii, jj, rows, stream.scene_mat,
                             stream.bounds, cam_row, block=stream.block,
                             samples=samples_per_pixel, max_depth=max_depth,
                             seed=seed, rr_start=rr_start,
                             sample_offset=sample_offset, budget=budget)
    return meshlib.all_reduce_sum(mesh, d_stream, d_cam)


def mse_train_stream(stream: StreamScene, cam_cfg: CameraConfig, target,
                     img_width: int, img_height: int, samples_per_pixel: int,
                     max_depth: int, *, seed: int = rtrng.DEFAULT_SEED,
                     dtype=torch.float32, gamma: bool = False,
                     pixel_order=None, mesh=None, rr_start=None,
                     loss: str = "mse", huber_delta: float = 1.0,
                     budget: int = RECORD_BUDGET):
    """The fused stream step: (loss, d_stream (rows, 16) in stream order,
    d_cam_row (1, 24)) against a target (H, W, 3), from one launch where
    the records fit ``budget`` in one window (else the windowed route of
    ``fused_stream_kernel``). The
    loss ('mse' | 'l1' | 'huber' | 'relmse') is a mean over pixels and
    channels of the image in linear radiance (``gamma=False``, the JAX
    package's only mode) or after gamma 2. The TPU schedule's keywords
    have no counterpart. ``mesh``: each rank runs the step on its slice of
    the lanes with the global loss constants; one ``all_reduce`` of one
    flat buffer sums the loss and the cotangents over the ranks."""
    tk.refuse_unported(dtype)
    ids, ii, jj, rows, cam_row = _lanes(stream, cam_cfg, img_width,
                                        img_height, samples_per_pixel, 0,
                                        pixel_order, mesh, target)
    num_pixels = img_width * img_height
    total, _img, d_stream, d_cam = _fused(
        ids, ii, jj, rows, stream.scene_mat, stream.bounds, cam_row,
        block=stream.block, samples=samples_per_pixel, max_depth=max_depth,
        num_pixels=num_pixels, seed=seed, rr_start=rr_start, gamma=gamma,
        loss=loss, huber_delta=huber_delta, budget=budget)
    total, d_stream, d_cam = meshlib.all_reduce_sum(mesh, total, d_stream,
                                                    d_cam)
    w = tk.loss_constants(samples_per_pixel, num_pixels, huber_delta)["w"]
    return total * w, d_stream, d_cam


@trace.spanned("rt.stream.to_slots")
def stream_grads_to_scene_mat(d_stream: torch.Tensor, stream: StreamScene,
                              n_slots: int) -> torch.Tensor:
    """Stream-order cotangents (rows, 16) -> scene slot order (n_slots,
    16) through ``perm``; inactive slots get zero."""
    out = torch.zeros((n_slots, kio.NUM_COLS), dtype=d_stream.dtype,
                      device=d_stream.device)
    out[stream.perm.long()] = d_stream[:stream.perm.shape[0]]
    return out
