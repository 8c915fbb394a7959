"""The forward render through the regeneration kernel.

The counterpart of ``raytracingincuda_tpu/ops/pallas_kernel.py``'s
``render_pallas(mode='regen')``. Every lane owns one pixel and traces
that pixel's samples back to back: when a path dies (miss, absorption,
depth cap or Russian roulette) the lane banks its radiance and starts
the pixel's next sample.

Two implementations share one signature:

  * ``regen_kernel`` launches the hand-written CUDA kernel
    (``csrc/regen_render.cu``, one thread per pixel) on CUDA tensors;
  * ``regen_reference`` is the plain PyTorch version: the JAX
    ``_regen_body`` recurrence, one wave at a time over all lanes.

``_regen`` (``kernel_io.by_device``) picks the kernel for CUDA tensors
and the plain version only for CPU tensors; nothing falls back from one to
the other. The kernel finds the closest hit with the two-level scan where
its launch builds a group table (``ops/group_scan.py``). The kernel's count
mode (``regen_counts``, with ``regen_counts_reference``,
``sample_segments``, ``warp_iterations`` and ``wave_rays`` beside it)
counts what each warp's loop runs instead of rendering.

Around them sit ``regen_inputs``, ``render_kernel`` (the
``render_pallas`` counterpart), the difficulty prepass
(``measure_difficulty``, ``difficulty_order``), which sorts pixels by
traced depth so that each warp holds pixels of similar path length, and
``make_diff_render``, the render as a ``torch.autograd.Function`` whose
backward is the gradient kernel (``ops/train_kernel.py``). The scene
matrix, the camera row and the lanes are ``ops/kernel_io.py``'s formats.
``render_kernel(mode=...)`` also takes the JAX package's older schedules:
``'simple'`` runs this kernel, ``'compact'`` the compact kernel
(``ops/compact_kernel.py``). ``mesh=`` (``parallel/mesh.py``) gives each
rank its slice of the lanes, padded to ``PAD`` lanes a rank, and
assembles the image on every rank.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.camera import CameraConfig, config_from_leaves, config_leaves
from ..models.camera import initialize  # noqa: F401  (the benchmark's)
from ..models.scene import Scene, SceneParams, param_leaves, params_from_leaves
from ..parallel import mesh as meshlib
from ..utils import trace
from . import group_scan
from . import kernel_io as kio
from . import rng as rtrng
from . import tracer, vec
from .kernel_io import (  # noqa: F401  (the JAX package's, the benchmark's)
    COL_ACTIVE, COL_ALB_B, COL_ALB_G, COL_ALB_R, COL_CX, COL_CY, COL_CZ,
    COL_FUZZ, COL_IOR, COL_MAT, COL_RADIUS, NUM_COLS, PAD, WARP, pack_camera,
    pack_scene_matrix)
from .tracer import linear_to_gamma, primary_rays_from_ij, shade_hit, sky_color
from .vec import Vec3

# The JAX package renders mode='compact' as 'simple' from this many pixels
# on (its compact kernel carries pixel ids as f32); the port keeps the rule.
COMPACT_MAX_PIXELS = 1 << 24
# the benchmark's name for the lanes' setup
_lane_setup = kio.lane_setup


def regen_reference(ids, ii, jj, budget, scene_mat, cam_row, *, samples: int,
                    max_depth: int, seed: int = rtrng.DEFAULT_SEED,
                    legacy_sky: bool = False, emit_depth: bool = False,
                    rr_start=None, sample_offset: int = 0,
                    finalize_scale: Optional[float] = None,
                    layout: str = "vmem") -> torch.Tensor:
    """Plain PyTorch version of the regeneration kernel.

    Lane ``i`` renders pixel ``ids[i]`` (column ``ii[i]``, row ``jj[i]``)
    over samples ``[sample_offset, budget[i])``. Returns a (3, padded) f32
    radiance sum (scaled by ``finalize_scale`` and gamma'd when given) or,
    with ``emit_depth``, a (1, padded) per-lane total of traced segments.
    Like the JAX kernel it stops after ``samples * max_depth`` waves,
    which never binds while ``budget - sample_offset <= samples``.
    ``layout`` only changes where the kernel keeps the scene."""
    rr_start = kio.check(ids, ii, jj, scene_mat, cam_row, rows=budget,
                         samples=samples, max_depth=max_depth,
                         rr_start=rr_start, sample_offset=sample_offset,
                         layout=layout)
    chunk = kio.reference_chunk(scene_mat.shape[0])
    scene = kio.scene_from_matrix(scene_mat)
    cam = kio.unpack_camera(cam_row)
    outs = [
        regen_lanes(*lanes, scene, cam, samples=samples, max_depth=max_depth,
                     seed=seed, legacy_sky=legacy_sky, emit_depth=emit_depth,
                     rr_start=rr_start, sample_offset=sample_offset,
                     finalize_scale=finalize_scale)
        for lanes in zip(ids.split(chunk), ii.split(chunk), jj.split(chunk),
                         budget.split(chunk))
    ]
    return torch.cat(outs, dim=1)


def regen_lanes(ids, fi, fj, budget, scene, cam, *, samples, max_depth, seed,
                 legacy_sky, emit_depth, rr_start, sample_offset,
                 finalize_scale, hit_fn=None):
    """The JAX ``_regen_body`` recurrence (K=1) over one chunk of lanes.
    ``hit_fn(o, d, active) -> HitResult`` replaces the all-slot hit test
    (the stream walk); ``active`` marks the lanes that trace this wave."""
    key = rtrng.key_from_seed(seed)
    pid = ids.to(torch.int64)
    shape, dev = pid.shape, pid.device
    zero_row = torch.zeros(shape, dtype=torch.float32, device=dev)
    zero3 = Vec3(zero_row, zero_row, zero_row)
    one3 = Vec3.full(shape, 1.0, 1.0, 1.0, device=dev)

    sample_f = torch.full(shape, float(sample_offset), device=dev)
    bounce_f = zero_row
    o, d = primary_rays_from_ij(cam, fi, fj, pid, sample_offset, key)
    prim_d, atten, acc, seg = d, one3, zero3, zero_row

    for _ in range(samples * max_depth):
        active = sample_f < budget
        if not bool(active.any()):
            break
        s_u = sample_f.to(torch.int64)
        b_u = bounce_f.to(torch.int64)
        closest = None if hit_fn is None else hit_fn(o, d, active)
        hit, p, sc = shade_hit(scene, o, d, pid, s_u, b_u, key, closest)

        survived = active & hit & sc.scattered
        # scattering at the depth cap exits black
        continues = survived & ~(bounce_f >= (max_depth - 1))
        atten_upd = atten * sc.attenuation
        if rr_start is not None:
            p_surv = vec.clip(
                torch.maximum(torch.maximum(atten_upd.x, atten_upd.y),
                              atten_upd.z),
                0.05, 1.0,
            )
            u_rr, _ = rtrng.uniform2(key, pid, s_u, b_u, rtrng.DRAW_RR)
            rr_zone = bounce_f >= float(rr_start)
            continues = continues & ~(rr_zone & (u_rr >= p_surv))
            atten_upd = atten_upd * torch.where(rr_zone, 1.0 / p_surv,
                                                torch.ones_like(p_surv))
        dies = active & ~continues

        if emit_depth:
            seg = seg + torch.where(dies, bounce_f + 1.0, zero_row)
        else:
            sky = sky_color(prim_d if legacy_sky else d)
            acc = acc + vec.where(active & ~hit, atten * sky, zero3)

        o = vec.where(continues, p, o)
        d = vec.where(continues, sc.direction, d)
        atten = vec.where(continues, atten_upd, atten)
        bounce_f = torch.where(continues, bounce_f + 1.0, bounce_f)

        # dying lanes regenerate with the pixel's next sample
        sample_next = sample_f + torch.where(dies, 1.0, 0.0)
        o_new, d_new = primary_rays_from_ij(cam, fi, fj, pid,
                                            sample_next.to(torch.int64), key)
        regen = dies & (sample_next < budget)
        o = vec.where(regen, o_new, o)
        d = vec.where(regen, d_new, d)
        atten = vec.where(regen, one3, atten)
        bounce_f = torch.where(regen, zero_row, bounce_f)
        if legacy_sky:
            prim_d = vec.where(regen, d_new, prim_d)
        sample_f = torch.where(dies, sample_next, sample_f)

    if emit_depth:
        return seg[None]
    rad = acc.stack(0)
    if finalize_scale is not None:
        rad = linear_to_gamma(rad * finalize_scale)
    return rad


_C_ARGTYPES = [
    ctypes.c_void_p,   # ids (int32)
    ctypes.c_void_p,   # ii
    ctypes.c_void_p,   # jj
    ctypes.c_void_p,   # budget
    ctypes.c_void_p,   # scene, SoA (11, N)
    ctypes.c_int,      # N
    ctypes.c_void_p,   # cam row
    ctypes.c_void_p,   # out (C, padded)
    ctypes.c_int,      # padded
    ctypes.c_int,      # max_depth
    ctypes.c_uint32,   # key word 0
    ctypes.c_uint32,   # key word 1
    ctypes.c_int,      # sample_offset
    ctypes.c_int,      # rr_start (-1 = off)
    ctypes.c_int,      # legacy_sky
    ctypes.c_int,      # emit_depth
    ctypes.c_int,      # fused finalize
    ctypes.c_float,    # finalize scale
    ctypes.c_int,      # hbm layout
    ctypes.c_void_p,   # group table (null: the one-level scan)
]


@trace.spanned("rt.launch.regen_render")
def regen_kernel(ids, ii, jj, budget, scene_mat, cam_row, *, samples: int,
                 max_depth: int, seed: int = rtrng.DEFAULT_SEED,
                 legacy_sky: bool = False, emit_depth: bool = False,
                 rr_start=None, sample_offset: int = 0,
                 finalize_scale: Optional[float] = None,
                 layout: str = "vmem") -> torch.Tensor:
    """Launch the CUDA regeneration kernel; same contract as
    ``regen_reference``. Launches on the current stream without
    synchronising; the kernel traces each lane's whole budget. Counts
    ``launch.regen_render``, and its scan (``group_scan``): with a group
    table, built by one launch before it, ``scan.two_level``, else
    ``scan.one_level``."""
    launch = kio.entry("regen_render", _C_ARGTYPES, ids.device)
    rr_start = kio.check(ids, ii, jj, scene_mat, cam_row, rows=budget,
                         samples=samples, max_depth=max_depth,
                         rr_start=rr_start, sample_offset=sample_offset,
                         layout=layout)
    padded = ids.shape[0]
    n = scene_mat.shape[0]
    soa = kio.soa(scene_mat)
    out = torch.empty((1 if emit_depth else 3, padded), dtype=torch.float32,
                      device=ids.device)
    k0, k1 = rtrng.key_from_seed(seed)
    groups = group_scan.group_table(soa, cam_row, layout)
    launch(
        ids.data_ptr(), ii.data_ptr(), jj.data_ptr(), budget.data_ptr(),
        soa.data_ptr(), n, cam_row.data_ptr(), out.data_ptr(), padded,
        max_depth, k0, k1, sample_offset,
        -1 if rr_start is None else rr_start, int(legacy_sky),
        int(emit_depth), int(finalize_scale is not None),
        0.0 if finalize_scale is None else finalize_scale,
        int(layout == "hbm"), kio.at(groups),
    )
    trace.count("launch.regen_render")
    group_scan.count_path(groups)
    return out


_COUNT_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # ids, ii, jj
    ctypes.c_void_p,   # budget
    ctypes.c_void_p,   # scene, SoA (11, N)
    ctypes.c_int,      # N
    ctypes.c_void_p,   # cam row
    ctypes.c_void_p,   # segments per lane (padded,) f32
    ctypes.c_void_p,   # hit-test issues per warp (padded // 32,) int32
    ctypes.c_void_p,   # groups opened per warp (padded // 32,) int32
    ctypes.c_void_p,   # slot tests per warp (padded // 32,) int32
    ctypes.c_int,      # padded
    ctypes.c_int,      # max_depth
    ctypes.c_uint32, ctypes.c_uint32,   # key words
    ctypes.c_int,      # sample_offset
    ctypes.c_int,      # rr_start (-1 = off)
    ctypes.c_int,      # legacy_sky
    ctypes.c_int,      # hbm layout
    ctypes.c_void_p,   # group table (null: the one-level scan)
]
LOOPS = ("regen", "nested", "compact", "pool")
# lanes a block of the compact kernel takes (csrc/compact_render.cu kTile)
POOL = 128


def regen_counts(ids, ii, jj, budget, scene_mat, cam_row, *, samples: int,
                 max_depth: int, seed: int = rtrng.DEFAULT_SEED,
                 legacy_sky: bool = False, rr_start=None,
                 sample_offset: int = 0, layout: str = "vmem"):
    """The kernel's count mode on the card: the render's loop, counting
    instead of rendering. Returns (segments per lane (padded,) f32, and per
    warp of 32 lanes, each (padded // 32,) int32: hit-test issues, the
    times the warp ran the closest-hit scan, as the leader of each group of
    lanes that ran it together counted them; the groups the two-level scan
    opened; the slot tests it issued: the large entries and ``GROUP`` an
    opened group a scan, or every slot a scan of the one-level scan).
    ``regen_counts_reference`` is its plain version."""
    launch = kio.entry("regen_counts", _COUNT_ARGTYPES, ids.device)
    rr_start = kio.check(ids, ii, jj, scene_mat, cam_row, rows=budget,
                         samples=samples, max_depth=max_depth,
                         rr_start=rr_start, sample_offset=sample_offset,
                         layout=layout)
    padded = ids.shape[0]
    soa = kio.soa(scene_mat)
    seg = torch.empty((padded,), dtype=torch.float32, device=ids.device)
    per_warp = [torch.empty((padded // WARP,), dtype=torch.int32,
                            device=ids.device) for _ in range(3)]
    k0, k1 = rtrng.key_from_seed(seed)
    groups = group_scan.group_table(soa, cam_row, layout)
    launch(ids.data_ptr(), ii.data_ptr(), jj.data_ptr(), budget.data_ptr(),
           soa.data_ptr(), scene_mat.shape[0], cam_row.data_ptr(),
           seg.data_ptr(), *(t.data_ptr() for t in per_warp), padded,
           max_depth, k0, k1, sample_offset,
           -1 if rr_start is None else rr_start, int(legacy_sky),
           int(layout == "hbm"), kio.at(groups))
    group_scan.count_path(groups)
    if groups is None:      # the one-level scan tests every slot an issue
        per_warp[2] = per_warp[0] * scene_mat.shape[0]
    return (seg, *per_warp)


def sample_segments(ids, ii, jj, budget, scene_mat, cam_row, *, samples: int,
                    sample_offset: int = 0, **kw) -> torch.Tensor:
    """(samples, padded) f32: the segments each lane traces in each of its
    samples, one render a sample (``emit_depth`` with a one-sample budget),
    on the kernel for CUDA tensors and the plain version for CPU tensors.
    A lane whose budget ends before a sample traces 0 segments in it."""
    rows = []
    for s in range(sample_offset, sample_offset + samples):
        one = torch.clamp(budget, max=float(s + 1)).contiguous()
        rows.append(_regen(ids, ii, jj, one, scene_mat, cam_row, samples=1,
                           sample_offset=s, emit_depth=True, **kw)[0])
    return torch.stack(rows)


def warp_iterations(seg: torch.Tensor, loop: str = "regen") -> torch.Tensor:
    """Warp issues of the closest-hit scan, from per-sample segments
    ``seg`` (samples, padded).

    Per warp of 32 lanes, float64 (padded // 32,): under the regenerating
    loop (``'regen'``) its longest lane's total; under a loop over samples
    around each sample's bounce loop (``'nested'``, kernel 1 before it
    regenerated, whose lanes wait at each sample's end for the warp's
    longest path) the sum over samples of the sample's longest path in the
    warp.

    Per block of ``POOL`` lanes (the compact kernel's; the last block takes
    the lanes left), float64 (ceil(padded / POOL),), where the live rays of
    a wave fill the block's first ceil(live / 32) warps: ``'compact'``, the
    per-sample pool (each sample's rays enter together, and at wave w the
    lanes whose path in that sample has more than w segments are live),
    summed over samples; ``'pool'``, the refilling pool (a lane's ray stays
    live until its last sample ends, so at wave w the lanes whose total
    exceeds w are live). The sum over waves of ceil(live / 32) is the sum
    of every 32nd of the block's values in descending order."""
    if loop not in LOOPS:
        raise ValueError(f"loop must be one of {LOOPS}, got {loop!r}")
    seg = seg.double()
    if loop in ("regen", "nested"):
        per = seg.reshape(seg.shape[0], -1, WARP)
        if loop == "regen":
            return per.sum(0).amax(1)
        return per.amax(2).sum(0)
    samples, padded = seg.shape
    blocks = -(-padded // POOL)
    per = seg.new_zeros((samples, blocks * POOL))
    per[:, :padded] = seg
    per = per.reshape(samples, blocks, POOL)
    if loop == "pool":
        per = per.sum(0, keepdim=True)
    lead = per.sort(dim=2, descending=True).values[:, :, ::WARP]
    return lead.sum(2).sum(0)


def regen_counts_reference(ids, ii, jj, budget, scene_mat, cam_row, *,
                           samples: int, max_depth: int,
                           seed: int = rtrng.DEFAULT_SEED,
                           legacy_sky: bool = False, rr_start=None,
                           sample_offset: int = 0, layout: str = "vmem"):
    """Plain version of the count mode: (segments per lane (padded,) f32,
    and per warp (padded // 32,) int32: iterations, groups opened, slot
    tests). The first two from the lanes' per-sample segments
    (``sample_segments``, ``warp_iterations``); the others from the
    regenerating recurrence wave by wave (a wave is one iteration of every
    warp's loop, and a warp's lanes in the scan are those that trace in it),
    each wave's rays through ``group_scan.model_scan`` on the table the
    launch would build (``group_table_reference``), or ``scene_mat``'s
    slots a scan where the launch scans in one level."""
    seg = sample_segments(ids, ii, jj, budget, scene_mat, cam_row,
                          samples=samples, sample_offset=sample_offset,
                          max_depth=max_depth, seed=seed,
                          legacy_sky=legacy_sky, rr_start=rr_start,
                          layout=layout)
    total = seg[0]
    for row in seg[1:]:     # in sample order, as the kernel adds them
        total = total + row
    issues = warp_iterations(seg).to(torch.int32)
    n = scene_mat.shape[0]
    if not group_scan.uses_groups(n, layout):
        zero = torch.zeros_like(issues)
        return total, issues, zero, (issues.long() * n).to(torch.int32)
    table = group_scan.unpack(
        group_scan.group_table_reference(scene_mat, cam_row), n)
    opened = torch.zeros(issues.shape, dtype=torch.int64)
    tests = torch.zeros(issues.shape, dtype=torch.int64)

    def count(o, d, active):
        nonlocal opened, tests
        res = group_scan.model_scan(table, o, d, active)
        opened = opened + res.opened
        tests = tests + res.tests
        return None

    wave_rays(ids, ii, jj, budget, scene_mat, cam_row, count,
              samples=samples, max_depth=max_depth, seed=seed,
              legacy_sky=legacy_sky, rr_start=rr_start,
              sample_offset=sample_offset)
    dev = issues.device
    return (total, issues, opened.to(dev, torch.int32),
            tests.to(dev, torch.int32))


def wave_rays(ids, ii, jj, budget, scene_mat, cam_row, fn, *, samples: int,
              max_depth: int, seed: int = rtrng.DEFAULT_SEED,
              legacy_sky: bool = False, rr_start=None,
              sample_offset: int = 0) -> None:
    """Run the plain version's regenerating recurrence over all lanes and
    call ``fn(o, d, active)`` with each wave's rays (``Vec3`` over the
    lanes) and the lanes that trace in it; the wave's closest hit is
    ``hit_world``'s. Lane i of a wave is the i-th lane of the kernel's
    loop at that iteration."""
    from .intersect import hit_world

    scene = kio.scene_from_matrix(scene_mat)

    def hit(o, d, active):
        fn(o, d, active)
        return hit_world(scene, o, d)

    rr_start = rtrng.validate_rr_start(rr_start)
    regen_lanes(ids, ii, jj, budget, scene, kio.unpack_camera(cam_row),
                 samples=samples, max_depth=max_depth, seed=seed,
                 legacy_sky=legacy_sky, emit_depth=True, rr_start=rr_start,
                 sample_offset=sample_offset, finalize_scale=None,
                 hit_fn=hit)


_regen = kio.by_device(regen_kernel, regen_reference)


def regen_inputs(scene: Scene, cam_cfg: CameraConfig, img_width: int,
                 img_height: int, samples_per_pixel: int, *,
                 pixel_order=None, sample_offset: int = 0,
                 sample_budgets=None, mesh=None) -> tuple:
    """The six tensors both regen implementations take, on the scene's
    device: (ids, ii, jj, budget, scene_mat, cam_row), the lanes of every
    rank of ``mesh``. The camera is derived from ``cam_cfg`` where that
    lives (the host, by default)."""
    scene_mat = pack_scene_matrix(scene)
    dev = scene_mat.device
    cam_row = kio.camera_row(cam_cfg, img_width, img_height, dev)
    lanes = kio.lane_setup(img_width, img_height, pixel_order,
                           samples_per_pixel, sample_offset, sample_budgets,
                           dev, mesh)
    return (*lanes, scene_mat, cam_row)


def render_kernel(
    scene: Scene,
    cam_cfg: CameraConfig,
    img_width: int,
    img_height: int,
    samples_per_pixel: int,
    max_depth: int,
    *,
    seed: int = rtrng.DEFAULT_SEED,
    layout: str = "vmem",
    legacy_sky: bool = False,
    gamma: bool = True,
    pixel_order: Optional[torch.Tensor] = None,
    return_depth: bool = False,
    rr_start=None,
    sample_offset: int = 0,
    sample_budgets=None,
    accumulate_only: bool = False,
    mode: str = "regen",
    mesh=None,
) -> torch.Tensor:
    """Render on the scene's device (kernel 1 on a card, which is where a
    scene factory called with no ``device`` puts it; the plain version on
    the CPU); (H, W, 3) f32, or with ``return_depth`` the (padded,)
    per-lane traced-segment totals.

    ``pixel_order``: optional (padded,) permutation of pixel ids; lanes
    take pixels in this order and the output is un-permuted, so it
    changes speed only. ``sample_offset`` / ``sample_budgets`` /
    ``accumulate_only`` render samples ``[offset, offset + budget)`` per
    pixel and return raw sums, which add up exactly across passes.
    Uniform-budget gamma renders finish 1/spp and gamma in the kernel.

    ``mode`` picks the schedule, as ``render_pallas``'s does; every mode
    gives the same image. ``'regen'``: the regeneration kernel.
    ``'simple'`` (the JAX per-sample waves with a whole-tile early exit)
    runs the regeneration kernel too: one thread per pixel tracing each
    sample's bounces in turn is that schedule on a GPU. ``'compact'``:
    live-ray compaction (``ops/compact_kernel.py``); with ``legacy_sky``,
    or at ``COMPACT_MAX_PIXELS`` (2^24) pixels or more, it runs
    ``'simple'``, as in JAX.
    ``return_depth``, ``sample_offset`` and ``sample_budgets`` need
    ``'regen'``. ``rr_start`` with ``'simple'`` or ``'compact'`` raises,
    where JAX silently renders the parity estimator.

    ``mesh`` (``parallel.mesh.Mesh``): this rank renders its slice of the
    lanes; the image (or the depth totals) reaches every rank, the same
    bits as one process renders (one ``all_reduce``)."""
    if mode not in ("regen", "compact", "simple"):
        raise ValueError(f"mode must be 'regen', 'compact' or 'simple', got "
                         f"{mode!r}")
    if mode != "regen":
        if return_depth:
            raise ValueError("return_depth requires mode='regen'")
        if sample_offset or sample_budgets is not None:
            raise ValueError("sample offset/budgets require mode='regen'")
        if rr_start is not None:
            raise ValueError(
                f"mode={mode!r} has no Russian-roulette estimator (JAX renders"
                " parity there); rr_start requires mode='regen'")
    if mode == "compact" and (legacy_sky or img_width * img_height
                              >= COMPACT_MAX_PIXELS):
        mode = "simple"
    inputs = regen_inputs(scene, cam_cfg, img_width, img_height,
                          samples_per_pixel, pixel_order=pixel_order,
                          sample_offset=sample_offset,
                          sample_budgets=sample_budgets, mesh=mesh)
    ids, padded = inputs[0], inputs[0].shape[0]
    ids_l, ii, jj, budget = kio.shard(mesh, *inputs[:4])
    fuse = (gamma and not accumulate_only and not return_depth
            and sample_budgets is None)
    scale = 1.0 / samples_per_pixel if fuse else None
    if mode == "compact":
        from . import compact_kernel

        out = compact_kernel.render_compact(
            ids_l, ii, jj, *inputs[4:], samples=samples_per_pixel,
            max_depth=max_depth, seed=seed, finalize_scale=scale,
            layout=layout)
    else:
        out = _regen(ids_l, ii, jj, budget, *inputs[4:],
                     samples=samples_per_pixel, max_depth=max_depth,
                     seed=seed, legacy_sky=legacy_sky,
                     emit_depth=return_depth, rr_start=rr_start,
                     sample_offset=sample_offset, finalize_scale=scale,
                     layout=layout)
    out = meshlib.gather_lanes(mesh, out, padded)
    if return_depth:
        return out[0]
    return kio.finalize_output(out, ids, pixel_order is not None,
                               img_width, img_height, samples_per_pixel,
                               gamma, accumulate_only, already_finalized=fuse)


def measure_difficulty(scene: Scene, cam_cfg: CameraConfig, img_width: int,
                       img_height: int, probe_depth: int = 8,
                       probe_samples: int = 4, *,
                       seed: int = rtrng.DEFAULT_SEED,
                       layout: str = "vmem") -> torch.Tensor:
    """Shallow prepass: per-pixel traced-segment TOTAL over
    ``probe_samples`` samples at depth ``probe_depth``, in pixel order,
    padded to ``PAD``."""
    return render_kernel(scene, cam_cfg, img_width, img_height, probe_samples,
                         probe_depth, seed=seed, layout=layout, gamma=False,
                         return_depth=True)


def difficulty_order(seg: torch.Tensor, probe_depth: int = 8,
                     probe_samples: int = 4) -> torch.Tensor:
    """Pixel order grouped by integer difficulty bucket: a stable sort,
    equal to the JAX package's counting sort (``_bucket_order``)."""
    buckets = seg.reshape(-1).to(torch.int32).clamp(0, probe_depth * probe_samples)
    return torch.argsort(buckets, stable=True).to(torch.int32)


def make_diff_render(mat_type, active, img_width: int, img_height: int,
                     samples_per_pixel: int, max_depth: int, *,
                     seed: int = rtrng.DEFAULT_SEED, gamma: bool = False,
                     legacy_sky: bool = False, pixel_order=None, mesh=None,
                     backward: str = "kernel", rr_start=None,
                     layout: str = "vmem", ray_tile=None, bwd_ray_tile=None,
                     bwd_sweep=None, bwd_window: int = 0,
                     bwd_pixels_per_lane=None):
    """Differentiable render: ``f(params, cam_cfg) -> (H, W, 3)`` on the
    params' device, whose forward is ``render_kernel`` (the regen kernel
    on a card) and whose gradient reaches every float leaf of ``params``
    and ``cam_cfg``.

    The counterpart of ``pallas_kernel.make_diff_render``, as a
    ``torch.autograd.Function``. ``backward='kernel'`` chains gamma and
    1/spp on the host, then runs the gradient kernel
    (``train_kernel.render_kernel_grads``) and ``chain_to_params``;
    ``backward='oracle'`` is autograd through ``tracer.render``. The
    gradient kernel has the current-bounce sky only, so ``legacy_sky``
    with ``backward='kernel'`` raises (the JAX package switches to the
    oracle silently). ``pixel_order`` orders both passes' lanes and
    changes speed only. ``mesh``: each rank renders and differentiates its
    slice of the lanes; the image reaches every rank (one ``all_reduce``
    in the forward pass) and the gradients are summed over the ranks (one
    in the backward pass). ``ray_tile``, ``bwd_ray_tile``, ``bwd_sweep``,
    ``bwd_window`` and ``bwd_pixels_per_lane`` shaped the TPU schedule
    and are ignored."""
    from . import train_kernel

    train_kernel.refuse_unported(layout=layout)
    meshlib.validate(mesh)
    del ray_tile, bwd_ray_tile, bwd_sweep, bwd_window, bwd_pixels_per_lane
    if backward not in ("kernel", "oracle"):
        raise ValueError(f"backward must be 'kernel' or 'oracle', got "
                         f"{backward!r}")
    if backward == "kernel" and legacy_sky:
        raise ValueError(
            "legacy_sky has no gradient kernel (it differentiates the "
            "current-bounce sky only); use backward='oracle'")
    n_params = 9

    def split(leaves):
        return (params_from_leaves(leaves[:n_params]),
                config_from_leaves(leaves[n_params:]))

    class _DiffRender(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *leaves):
            params, cfg = split(leaves)
            img = render_kernel(
                Scene(params, mat_type, active), cfg, img_width, img_height,
                samples_per_pixel, max_depth, seed=seed, layout=layout,
                legacy_sky=legacy_sky, gamma=gamma, pixel_order=pixel_order,
                rr_start=rr_start, mesh=mesh)
            ctx.save_for_backward(*leaves, img)
            return img

        @staticmethod
        def backward(ctx, g):
            *leaves, img = ctx.saved_tensors
            if backward == "oracle":
                return _oracle_vjp(leaves, g)
            params, cfg = split(leaves)
            if gamma:
                # d sqrt(x) = 0.5 / sqrt(x) = 0.5 / img, 0 at black
                pos = img > 0
                g = torch.where(pos, 0.5 * g / torch.where(pos, img, 1.0),
                                torch.zeros_like(g))
            g_acc = g * (1.0 / samples_per_pixel)
            d_sm, d_cr = train_kernel.render_kernel_grads(
                Scene(params, mat_type, active), cfg, g_acc, img_width,
                img_height, samples_per_pixel, max_depth, seed=seed,
                pixel_order=pixel_order, rr_start=rr_start, layout=layout,
                mesh=mesh)
            d_params, d_cfg = train_kernel.chain_to_params(
                d_sm, d_cr, params, cfg, mat_type, active, img_width,
                img_height)
            return (*param_leaves(d_params), *config_leaves(d_cfg))

    def _oracle_vjp(leaves, g):
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        params, cfg = split(leaves)
        with torch.enable_grad():
            img = tracer.render(
                Scene(params, mat_type, active), cfg, img_width, img_height,
                samples_per_pixel, max_depth, seed=seed, gamma=gamma,
                legacy_sky=legacy_sky, rr_start=rr_start, mesh=mesh)
            grads = torch.autograd.grad(img, leaves, g, allow_unused=True)
        return tuple(torch.zeros_like(t) if d is None else d
                     for d, t in zip(grads, leaves))

    def f(params: SceneParams, cam_cfg: CameraConfig) -> torch.Tensor:
        return _DiffRender.apply(*param_leaves(params),
                                 *config_leaves(cam_cfg))

    return f
