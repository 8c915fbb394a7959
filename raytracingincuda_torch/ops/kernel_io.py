"""The layer under the kernel wrappers (``render_kernel``,
``train_kernel``, ``stream_kernel``, ``stream_train_kernel``,
``compact_kernel``, ``f64_kernel`` and ``group_scan``'s table launch):
the formats the kernels read and write (the lanes, the (N, 16) scene
matrix and the (1, 24) camera row), ``check`` of what every kernel and
its plain version take, ``entry`` (a C entry of ``_build``'s library as a
launch on the current stream), ``reduce_rows`` (block partials summed in
a fixed order) and ``by_device`` (the kernel for CUDA tensors, its plain
version for CPU tensors).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

from ..models.camera import Camera, CameraConfig, initialize
from ..models.scene import (Scene, SceneParams, param_leaves,
                            params_from_leaves, round_up)
from ..parallel import mesh as meshlib
from ..parallel.mesh import PAD
from ..utils import trace
from . import _build
from . import rng as rtrng
from .backward import N_CAM, camera_from_scalars
from .tracer import linear_to_gamma
from .vec import Vec3

# -- lanes --------------------------------------------------------------------

# The most lanes (the padded pixels of every rank together) a call takes.
# Lane ids are int32 and the kernels read them as uint32; coordinates are
# f32, exact for widths and heights below 2^24. The bound is the kernels'
# 32-bit index products: a (3, lanes) row array is indexed as
# c * lanes + i in int (csrc/*.cu), which holds while 3 x lanes < 2^31.
# Widening those products to size_t would raise the bound to the ids'
# 2^31, but at this one a render's lane rows and image already take 20 GB.
MAX_LANES = (2**31 - 1) // 3 // PAD * PAD
WARP = 32
# The plain versions bound their (scene rows x lanes) temporaries to this
# many elements by tracing lanes in chunks (lanes are independent).
REFERENCE_CHUNK_ELEMS = 1 << 24


def reference_chunk(rows: int, elems: int = REFERENCE_CHUNK_ELEMS) -> int:
    """Lanes a chunk of a plain version over ``rows`` scene rows: a
    multiple of ``PAD``, with at most ``elems`` temporaries where it can."""
    return max(PAD, elems // rows // PAD * PAD)


@trace.spanned("rt.lanes")
def lane_setup(img_width, img_height, pixel_order, samples_per_pixel,
               sample_offset, sample_budgets, device, mesh=None):
    """Lane -> pixel plumbing: padding to ``PAD`` lanes on every rank of
    ``mesh``, the optional pixel order, f32 pixel coordinates, and
    per-lane ABSOLUTE budgets (exclusive end sample ids). Returns (ids,
    ii, jj, budget) over all the ranks' lanes (``shard`` takes this
    rank's). An order over one process's lanes (``PAD``-padded) is
    extended with the padding ids under a mesh. Raises where the lanes of
    every rank together exceed ``MAX_LANES``."""
    num_pixels = img_width * img_height
    padded = meshlib.padded_lanes(num_pixels, mesh)
    if padded > MAX_LANES:
        raise ValueError(
            f"a {img_width}x{img_height} image pads to {padded} lanes, above "
            f"MAX_LANES = {MAX_LANES} (the kernels' 32-bit index products)")
    if pixel_order is not None:
        n = pixel_order.shape[0] if pixel_order.dim() == 1 else -1
        if n not in (round_up(num_pixels, PAD), padded):
            raise ValueError(f"pixel_order must have shape ({padded},), "
                             f"got {tuple(pixel_order.shape)}")
        ids = pixel_order.to(device=device, dtype=torch.int32)
        if n < padded:
            ids = torch.cat([ids, torch.arange(n, padded, dtype=torch.int32,
                                               device=device)])
        ids = ids.contiguous()
    else:
        ids = torch.arange(padded, dtype=torch.int32, device=device)
    ii = (ids % img_width).to(torch.float32)
    jj = torch.div(ids, img_width, rounding_mode="floor").to(torch.float32)

    if sample_budgets is not None:
        nb = torch.as_tensor(sample_budgets).reshape(-1)
        if tuple(nb.shape) != (num_pixels,):
            raise ValueError(f"sample_budgets must have shape ({num_pixels},)")
        with trace.sync():
            lo, hi = torch.stack(torch.aminmax(nb)).tolist()
        if lo < 0 or hi > samples_per_pixel:
            raise ValueError(
                f"sample_budgets must lie in [0, {samples_per_pixel}]")
        nb_pad = torch.zeros(padded, dtype=torch.float32, device=device)
        nb_pad[:num_pixels] = nb.to(device=device, dtype=torch.float32)
        budget = float(sample_offset) + nb_pad[ids.long()]
    else:
        budget = torch.full((padded,), float(sample_offset + samples_per_pixel),
                            dtype=torch.float32, device=device)
    return ids, ii, jj, budget


@trace.spanned("rt.lanes")
def lane_rows(img, ids, num_pixels: int) -> torch.Tensor:
    """(H, W, 3) per-pixel data -> (3, padded) lane rows: lane i carries
    pixel ids[i]'s values, zeros for padding."""
    padded = ids.shape[0]
    flat = torch.as_tensor(img).reshape(num_pixels, 3).to(
        device=ids.device, dtype=torch.float32)
    pad = torch.zeros((padded, 3), dtype=torch.float32, device=ids.device)
    pad[:num_pixels] = flat
    return pad[ids.long()].t().contiguous()


def shard(mesh, *lanes) -> tuple:
    """This rank's contiguous slice of each lane tensor (the last axis)."""
    sl = meshlib.local_slice(lanes[0].shape[-1], mesh)
    return tuple(t[..., sl].contiguous() for t in lanes)


@trace.spanned("rt.finalize")
def finalize_output(acc, ids, use_sort, img_width, img_height,
                    samples_per_pixel, gamma, accumulate_only,
                    already_finalized):
    """Un-permute sorted lanes; then the raw sum (``accumulate_only``),
    the kernel's fused finalize, or 1/spp and gamma here."""
    acc = acc.t()                                        # (padded, 3)
    if use_sort:
        out = torch.zeros_like(acc)
        out[ids.long()] = acc
        acc = out
    img = acc[:img_width * img_height]
    if not (already_finalized or accumulate_only):
        img = img * (1.0 / samples_per_pixel)
        if gamma:
            img = linear_to_gamma(img)
    return img.reshape(img_height, img_width, 3)


# -- the scene matrix ---------------------------------------------------------

# Scene-matrix columns (the JAX pack_scene_matrix layout).
COL_CX, COL_CY, COL_CZ = 0, 1, 2
COL_RADIUS = 3
COL_ALB_R, COL_ALB_G, COL_ALB_B = 4, 5, 6
COL_FUZZ, COL_IOR, COL_MAT, COL_ACTIVE = 7, 8, 9, 10
NUM_COLS = 16
# the columns the kernels read (``soa``)
USED_COLS = 11
# the columns that carry gradients (centre, radius, albedo, fuzz, ior), in
# the order of the SceneParams leaves; mat/active and the spare columns
# get zeros
GRAD_COLS = 9
# layout='vmem' stages the scene in shared memory (44 bytes a slot, about
# 180 KB at this bound, inside the 227 KB a Hopper block may take).
MAX_VMEM_SLOTS = 4096


def pack_scene_matrix(scene: Scene) -> torch.Tensor:
    """Scene -> (N, 16) f32 attribute matrix on the scene's device."""
    cols = [*param_leaves(scene.params), scene.mat_type, scene.active]
    m = torch.zeros((scene.num_slots, NUM_COLS), dtype=torch.float32,
                    device=scene.mat_type.device)
    for k, c in enumerate(cols):
        m[:, k] = c.to(torch.float32)
    return m


def scene_from_matrix(scene_mat: torch.Tensor) -> Scene:
    """A Scene view over the columns of a packed matrix."""
    col = lambda k: scene_mat[:, k]  # noqa: E731
    return Scene(
        params=SceneParams(
            center=Vec3(col(COL_CX), col(COL_CY), col(COL_CZ)),
            radius=col(COL_RADIUS),
            albedo=Vec3(col(COL_ALB_R), col(COL_ALB_G), col(COL_ALB_B)),
            fuzz=col(COL_FUZZ),
            ior=col(COL_IOR),
        ),
        mat_type=col(COL_MAT).to(torch.int32),
        active=col(COL_ACTIVE) > 0.5,
    )


def soa(scene_mat: torch.Tensor) -> torch.Tensor:
    """The kernels' view of a scene or stream matrix: its columns 0-10 as
    one contiguous (11, rows) array."""
    return scene_mat[:, :USED_COLS].t().contiguous()


def scene_cotangent(d_scene_mat: torch.Tensor,
                    params: SceneParams) -> SceneParams:
    """The cotangent of ``pack_scene_matrix`` at ``params``, from an
    (N, 16) or (N, 9) one of the matrix: leaf k's is column k, cast to the
    leaf's dtype and device (the bits autograd through the packing gives)."""
    return params_from_leaves([
        torch.empty_like(leaf).copy_(d_scene_mat[:, k])
        for k, leaf in enumerate(param_leaves(params))])


def grad_outputs(d9: torch.Tensor, dcam: torch.Tensor) -> tuple:
    """The gradient kernels' (N, 9) scene and (18,) camera sums in the
    shapes of what they differentiate: (d_scene_mat (N, 16), d_cam_row
    (1, 24)), zero past the summed columns."""
    pad = torch.nn.functional.pad
    return pad(d9, (0, NUM_COLS - GRAD_COLS)), pad(dcam, (0, 24 - N_CAM))[None]


# -- the camera row -----------------------------------------------------------

def pack_camera(cam: Camera) -> torch.Tensor:
    """Derived camera -> (1, 24) f32 row."""
    vals = [
        *cam.pixel00_loc, *cam.pixel_delta_u, *cam.pixel_delta_v,
        *cam.center, *cam.defocus_disk_u, *cam.defocus_disk_v,
        cam.use_defocus,
    ]
    row = torch.zeros((1, 24), dtype=torch.float32, device=cam.center.x.device)
    for k, v in enumerate(vals):
        row[0, k] = v.to(torch.float32)
    return row


def unpack_camera(cam_row: torch.Tensor) -> Camera:
    """A Camera view over the scalars of a (1, 24) row."""
    return camera_from_scalars(cam_row[0], cam_row[0, 18] > 0.5)


def camera_row(cam_cfg: CameraConfig, img_width: int, img_height: int,
               device) -> torch.Tensor:
    """The (1, 24) camera row on ``device``, derived from ``cam_cfg`` where
    that lives (the host, by default): span ``rt.camera``, its copy to the
    card a host sync."""
    with trace.span("rt.camera"), torch.no_grad():
        row = pack_camera(initialize(cam_cfg, img_width, img_height))
        with trace.sync():
            return row.to(device)


# -- the checks ---------------------------------------------------------------

def check(ids, ii, jj, scene_mat, cam_row, *, samples: int, max_depth: int,
          rows=None, rr_start=None, sample_offset: int = 0,
          layout: str = "vmem", cam_dtype=torch.float32):
    """What a kernel and its plain version take; raises on anything else:
    contiguous tensors on the device of ``ids`` (int32, a multiple of
    ``PAD`` and at most ``MAX_LANES`` lanes), f32 ``ii`` and ``jj`` as
    long, the (N, 16) f32 ``scene_mat``, the camera row ((1, 24) f32, or
    with ``cam_dtype=torch.float64`` ``initialize_f64``'s (24,)) and
    ``rows`` where given: a (padded,) budget or (3, padded) f32 rows. The
    scene fits ``layout``; the sample and bounce ids fit the sampler.
    Returns ``rr_start`` as ``rng.validate_rr_start`` gives it."""
    tensors = [("ids", ids, torch.int32, None),
               ("ii", ii, torch.float32, ids.shape),
               ("jj", jj, torch.float32, ids.shape),
               ("scene_mat", scene_mat, torch.float32, None)]
    if rows is not None:
        tensors.append(("budget", rows, torch.float32, ids.shape)
                       if rows.dim() == 1 else
                       ("rows", rows, torch.float32, (3, *ids.shape)))
    tensors.append(("cam_row", cam_row, cam_dtype,
                    (1, 24) if cam_dtype == torch.float32 else (24,)))
    for name, t, dtype, shape in tensors:
        if t.device != ids.device:
            raise ValueError(f"{name} is on {t.device}, ids on {ids.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ids.dim() != 1 or ids.shape[0] % PAD or ids.shape[0] > MAX_LANES:
        raise ValueError(f"ids must be 1-D, a multiple of {PAD} long and at "
                         f"most MAX_LANES = {MAX_LANES} long; got "
                         f"{tuple(ids.shape)}")
    if scene_mat.dim() != 2 or scene_mat.shape[1] != NUM_COLS:
        raise ValueError(f"scene_mat must be (N, {NUM_COLS}), got "
                         f"{tuple(scene_mat.shape)}")
    if layout not in ("vmem", "hbm"):
        raise ValueError(f"layout must be 'vmem' or 'hbm', got {layout!r}")
    if layout == "vmem" and scene_mat.shape[0] > MAX_VMEM_SLOTS:
        raise ValueError(
            f"layout='vmem' stages at most {MAX_VMEM_SLOTS} slots in shared "
            f"memory, the scene has {scene_mat.shape[0]}; use layout='hbm'"
        )
    if max_depth < 1 or samples < 1 or sample_offset < 0:
        raise ValueError("samples and max_depth must be positive and "
                         "sample_offset non-negative")
    rtrng.validate_stream_ids(sample_offset + samples, max_depth)
    return rtrng.validate_rr_start(rr_start)


# -- the launch ---------------------------------------------------------------

def entry(name: str, argtypes: Sequence, device: torch.device) -> Callable:
    """C entry ``name`` of the library (built at first use) as a launch on
    ``device``'s current stream: ``launch(*args)`` passes ``args`` and the
    stream, and raises on a CUDA error. Refuses any device but CUDA, so a
    wrapper that asks for its entry first refuses other tensors."""
    if device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {device}")
    fn = _build.function(name, [*argtypes, ctypes.c_void_p])
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(*args) -> None:
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")

    return launch


def at(t: Optional[torch.Tensor], row: int = 0, col: int = 0) -> int:
    """The address of t[row, col] (t[col] for a vector); 0 for None."""
    if t is None:
        return 0
    stride = t.stride(0) if t.dim() > 1 else 0
    return t.data_ptr() + (row * stride + col) * t.element_size()


# rows summed per thread in each pass of the fixed-order block reduction
_REDUCE_CHUNK = 64
_P, _I = ctypes.c_void_p, ctypes.c_int


@trace.spanned("rt.launch.reduce_rows")
def reduce_rows(partials: torch.Tensor) -> torch.Tensor:
    """Sum a (rows, cols) partials buffer over rows in a fixed order:
    passes of ``_REDUCE_CHUNK``-row groups, each summed in row order, so
    the result is the same bits on every run."""
    launch = entry("reduce_rows", [_P, _I, _I, _I, _P], partials.device)
    x = partials
    while x.shape[0] > 1:
        rows, cols = x.shape
        out = torch.empty((-(-rows // _REDUCE_CHUNK), cols),
                          dtype=torch.float32, device=x.device)
        launch(x.data_ptr(), rows, cols, _REDUCE_CHUNK, out.data_ptr())
        x = out
    return x[0]


# -- the dispatch -------------------------------------------------------------

def by_device(kernel: Callable, reference: Callable) -> Callable:
    """One implementation a call, by the device of the first argument:
    ``kernel`` for CUDA tensors, ``reference`` (its plain version) for CPU
    tensors; nothing falls back from one to the other, and any other
    device raises."""
    def dispatch(first, *args, **kw):
        if first.device.type == "cuda":
            return kernel(first, *args, **kw)
        if first.device.type == "cpu":
            return reference(first, *args, **kw)
        raise ValueError(f"no implementation of {kernel.__name__} for "
                         f"device {first.device}")

    return dispatch
