#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each prints one line ending in the card's nvidia-smi name and
power limit; any failure raises and the exit code is not 0; there is no
CPU path):

  0 device   the card (nvidia-smi name and power limit), CUDA, driver
  1 build    nvcc builds the kernels from raytracingincuda_torch/csrc
  2 goldens  the regen kernel against the six committed goldens
  3 compare  the regen kernel against its plain PyTorch version on the
             card: scene 1 at 320x192x10spp/25b (parity and rr2, both
             scene layouts, the prepass segments, run-to-run bit
             identity), and at the headline's shapes (1280x768, 2 spp,
             25b); there, the count mode (regen_counts): hit-test issues
             per warp against the lanes' mean segments, equal to
             warp_iterations of the kernel's per-sample segments, and
             those segments' count under the nested loop kernel 1 ran
             before it regenerated and under the compact kernel's
             per-sample and refilling pools
  4 headline make_renderer at scene 1, 1280x768, 100 spp, 25 bounces,
             parity and rr2 (no difficulty order): one warm-up and 3 timed
             renders each (CUDA events), the kernel's launch count over
             that run; then 10 pairs of a render with the difficulty order
             (render_kernel) and one through the renderer, and the count
             mode at this shape with and without the order
  5 cli      python -m raytracingincuda_torch.cli at 320x192x10spp
  6 grads    the gradient kernel against its plain version (scene 1,
             320x192x4spp/8b, parity and rr2, both layouts, run-to-run
             bit identity); the fused step kernel against its plain
             version (64x40x8spp/6b rr2, four losses, gamma on and off;
             its image bit-equal to the regen kernel's) and at the
             headline's shapes with 2 spp; at those shapes (parity and
             rr2) the fused kernel's outputs bit-equal with nothing
             parked, with a capacity that overflows mid-lane, with the
             default, in two window sizes and with the warps'
             accumulators in shared memory, and the gradient kernel fed
             the fused kernel's own g equal to its gradients bit for bit
  7 train    make_mse_train (the fused step) at scene 1, 1280x768,
             100 spp, 25 bounces, rr2, gamma, MSE, the difficulty order:
             one warm-up and 3 timed steps (CUDA events), finite
             gradients, the loss equal to the image's MSE, peak memory
             beside the park's budget; one more step in a torch.profiler
             window (its device time split between the park render, the
             reverse and reduce_rows); the park's plan at the step's
             inputs, entries a lane (mean, max) and the share of samples
             re-traced
  8 trainer  the package's inverse-rendering example (20 Adam steps,
             impl fused) with a falling loss, then one make_train_step
             (impl kernel) step from gray albedos through make_diff_render
  9 stream   the stream kernel against its plain version, bit for bit
             and from run to run, with equal work counts: 10k random
             spheres (seed 3) at 64x40x2spp/6b, parity and rr2, and scene
             1 as one block; Morton against front-to-back order (share of
             equal components); 100k spheres at 160x96x2spp/10b against
             the regen kernel's hbm image (share)
  10 stream headline  make_renderer(impl='stream') at 100k spheres,
             640x384, 10 spp, 10 bounces: a warm-up and 3 timed renders,
             launches, peak memory, the walk's work counts (segments,
             opened blocks, the warps' union) and bound; one brute-force
             hbm render of the same scene at 2 spp
  11 stream grads  the stream train kernel against its plain versions:
             gradients at 1000 spheres (block 64), 64x40x4spp/6b, parity
             and rr2; the fused step for four losses, gamma on and off,
             its image bit-equal to the stream kernel's
  12 stream train  make_stream_train (fused) at 100k spheres, 640x384,
             4 spp, 10 bounces, MSE: a warm-up and 3 timed steps, finite
             gradients, the loss equal to the image's MSE, peak memory,
             and one more step in a torch.profiler window (device time
             over wall time: the idle share); one fused=False step (the
             same loss to GRAD_RTOL); on this step's records,
             record_order's time, and the segmented sum against its plain
             version (bit for bit) and index_add_; the warp-union count of
             the step's walk (stream_train_kernel.walk_counts: blocks
             opened per lane, equal to the stream kernel's count, and
             blocks walked and rows tested per warp) beside the stream
             kernel's own union at the same shape; the walk's tables
             (scan_table_kernel) on the step's stream against their
             twin (walk_groups_reference) word for word; on the step's own
             stream (100k
             spheres, blocks of 256 front to back) at 640x384x1spp/3b,
             the stream kernel (bit for bit) and both modes of the stream
             train kernel against their plain versions
  13 stream scale  1M spheres: the block after _auto_block, one forward
             at 640x384x1spp/10b and one fused step at 1spp/6b, finite
             gradients, peak memory; the walk's tables against their
             twin; the stream kernel and the fused mode
             against their plain versions on its blocks of 1024 at
             64x40x1spp/6b
  14 stream cli  the CLI with --impl stream and --layout packed at scene
             1, 320x192x10spp (the file names, images against the regen
             kernel's), and the example with --impl stream --n_spheres
             2000 --steps 20 (a falling loss)
  15 f64 compare  the f64 kernel against its plain version, bit for bit
             and from run to run: scene 1 at 320x192x4spp/8b (both
             layouts) and at the headline's width (1280x768, 2 spp, 25b);
             a window of samples at sample_offset 5 at 64x40x4spp/8b (both
             layouts; not the window at 0)
  16 f64 headline  make_renderer(dtype='float64') at scene 1, 1280x768,
             100 spp, 25 bounces, parity, vmem, raster order (no f32
             prepass): one warm-up and 3 timed renders, launches (the f64
             kernel's alone), and the image's
             gap to phase 4's f32 parity image (mean |d| in 8-bit levels,
             share of components >= 1 level); the CLI with --dtype
             float64 at 320x192x10spp (its file equal to the renderer's
             image)
  17 compact the compact kernel against its plain version and the regen
             kernel at 320x192x10spp/25b (both layouts) and at the
             headline's width (2 spp, 25b), bit for bit; mode='simple'
             with legacy_sky equal to the regen kernel's legacy image;
             render_kernel(mode='compact') at the headline (100 spp, 25b,
             parity): a warm-up and 3 timed renders beside 3 of the regen
             kernel unsorted, the images bit-equal, the time ratio and the
             ratio of warp scans (the refilling pool's blocks against kernel
             1's warps, rk.warp_iterations on phase 4's segments); one
             mode='simple' render at the headline (kernel 1's launches)
             equal to them
  18 adaptive  impl='adaptive' (ops/adaptive.py) at 64x40 (base 4, max
             16, tol 0.1, rounds 1 and 2): the card's render_adaptive
             bit-equal to the plain versions' (image and spp map), the
             renderer's image equal to it, zero-extra pixels equal to
             gamma((A+B)/4) of the same probes; at the headline (scene 1,
             1280x768, 25 bounces, parity, base 16, max 256, tol 0.05,
             rounds 1 and 2) through make_renderer: a warm-up and 3 timed
             renders (CUDA events around the whole render), spp mean, min
             and max, kernel 1's launches a render, the host syncs of one
             render (torch.cuda's sync debug mode) and the idle share of
             one torch.profiler window; 10 pairs of the headline refine in
             the budget-bucket order against raster (sums bit-equal); and
             the quality table of benchmarks/adaptive_probe.py: uniform
             16/32/64/100 spp and its seven adaptive schedules against a
             1024-spp truth from samples 4096 on (a window no schedule
             reaches): ms, mean spp, the per-pixel channel-mean |error|'s
             mean, p99 and p99.9, and err^2 x ms
  19 adaptive stream  make_renderer(impl='adaptive') on 100k random
             spheres (above 4096 slots: kernel 4), 640x384, 10 bounces,
             base 4, max 32, tol 0.1: a warm-up and 3 timed renders, kernel
             4's launches, spp; render_adaptive on a 200-sphere explicit
             stream (blocks of 64) at 64x40, card bit-equal to plain
  20 assets and pose  scene 1 through .npz and .csv on the card (arrays
             equal, 512 slots, the same render); cli --scene_file on the
             .npz writes the bytes of --scene_id 1's file at 320x192; cli
             --impl adaptive runs; the serial scene's sha256 is the pin;
             the two pose examples at their defaults on the card (exit 0
             or 1, the final pose error, kernel 1's launches, and kernel
             3's for joint recovery's train steps)
  21 f64 oracle  tracer.render(dtype=float64) on the card (plain PyTorch,
             as JAX's oracle is plain jnp): autograd against f64 central
             differences (albedo, radius, vfov) at the JAX package's FD
             shape and tolerances (scene 2, 24x16x2spp/4b, h 1e-6); scene
             1 (512 slots) at 32x20x2spp/4b against the CPU (image within
             1e-12, gradients within 1e-8 of each leaf's largest entry plus
             1e-15); render_grads at the largest image whose autograd graph
             fits in half the free memory (size from a 64x40 probe's bytes
             a pixel; its time, peak memory, finite gradients); the render
             at that shape through make_renderer(impl='oracle',
             dtype='float64') (2 timed) beside the f64 kernel's (3 timed)
  22 two ranks  parallel/worker.py under torchrun --nproc_per_node 2
             (gloo, both ranks on the one card): the headline parity and
             rr2 renders (bit-equal to phase 4's images; parity's PPM
             through part files and the stitch equal to phase 4's bytes), phase
             7's fused step, kernel 3's gradients (320x192x4spp/8b rr2),
             the compact kernel (320x192x10spp/25b), the 100k stream render
             (bit-equal to phase 10's) and stream step, adaptive sampling
             at 64x40 (rounds 1 and 2; image and spp map) against the same
             jobs in this process on one rank: forward paths bit for bit,
             the gradient paths' loss within rtol 1e-6 and the rest within
             rtol 1e-4 / atol 1e-7, bit-identical from run to run, one
             all_reduce a fused step; each rank's kernel launches; then
             the CLI under torchrun --devices 2 at 320x192 (its file's
             bytes equal one process's). Times are two ranks sharing one
             card, not a multi-device speed-up
  23 routes  the routes the JAX package takes for the same config: the
             adaptive headline (phase 18's, rounds 1) with layout='packed'
             through make_renderer (one render_adaptive call, kernel 1's
             launches, image and spp map bit-equal to phase 18's vmem
             render); the f64 oracle with rr_start=2 and with legacy_sky
             on the card against the CPU (32x20x2spp/4b, within 1e-12);
             render_incremental at float64 in two rounds against the
             one-shot f64 oracle on the card (within 1e-12), with
             impl='kernel' (two f64 kernel launches at the rounds'
             sample_offsets, no oracle call) against one make_renderer
             render at 320x192x4spp/25b (within 1e-12), and with
             impl='kernel', layout='packed' (kernel 4, two rounds) against
             one render_stream render at 320x192x4spp/25b (within 1e-6);
             the CLI with --dtype float64 --impl oracle --rr_start 2 in
             this process (rc 0, a float64 scene and camera, its PPM the
             renderer's image)
  24 train checkpoints  make_train_step(impl='fused') with SGD-momentum
             and with AdamW (torch.optim) at scene 1, 320x192x4spp/8b,
             albedo and fuzz trained: 3 steps straight against 1 step,
             save_train_state, load_train_state onto a fresh template and
             2 steps; params and optimizer state bit-equal (keys, kinds,
             devices, dtypes), kernel 2's launches
  25 deep paths and record windows  kernels 2 and 3 on the deep scene
             (models/scene.py:build_deep_scene) at 160x96x2spp/128b,
             parity and rr2, on the reverse's 256-deep instance against
             their plain versions (images bit-equal to plain and regen,
             gradients within GRAD_RTOL, run-to-run identical) and the
             share of banking paths that end beyond bounce 64; the 64 and
             256 instances at depth 64 in turns (kernel 3's and kernel 2's
             table shapes and the deep scene): times and equal bits;
             make_mse_train and render_kernel_grads at depth 128 (launch
             counts); phases 7 and 12 against PERF.md's section 5 (within
             2%, printed); kernel 5's gradient mode in forced record
             windows at 64x40 against its plain version in the same
             windows; phase 12's cell at a forced budget (4 windows:
             kernel 4's render, the loss block, kernel 5 a window)
             against its one-launch step; and make_stream_train at 100k,
             640x384, 100 spp, 25 bounces, which raised before record
             windows: windows, 3 timed steps from one state
             (bit-identical), peak memory (the largest window's records
             and their sort within the budget, the peak within it plus
             256 MiB for the step's tensors), launches
  26 large images  images of 2^24 pixels and more (up to
             kernel_io.MAX_LANES lanes), each kernel held to its plain
             version on sampled lanes with pixel ids >= 2^24 (the image's
             last lanes and lanes drawn above 2^24): make_renderer at
             7680x4320x4spp/25b parity, scene 1 (kernel 1: best of 3,
             16,384 sampled lanes bit-equal to regen_reference, the count
             mode's issues over the lanes' mean segments, peak memory);
             write_ppm's time there and the CLI at the same config (its
             render_ms,e2e_ms line; its PPM holds 33,177,600 pixels, the
             bytes write_ppm gives for the phase's image); at 4096x4104:
             make_mse_train 2spp/25b rr2 (park windows, the image
             bit-equal to kernel 1's), render_kernel_grads with g zero but
             on 16,384 sampled lanes against grad_reference there; on the
             100k stream at 1spp/10b make_renderer(impl='stream') (4096
             sampled lanes bit-equal to stream_reference),
             render_stream_grads in lane-chunk record windows against
             stream_grads_reference on sampled lanes, and
             make_stream_train's step; make_renderer(dtype='float64') at
             1spp/8b (sampled lanes' sums bit-equal to f64_reference); the
             adaptive route (base 4, max 16)
  27 defaults  build_scene(1) and build_random_scene(10_000, seed=3)
             called with no device land on the card; render_kernel
             (kernel 1) and render_stream (kernel 4) render them at
             320x192x2spp/8b, and each image is bit-equal to the same
             render of the scene built with device='cuda'

Then the kernels line (JSON, with each kernel's bound and, as
bound_fmad_off_ms, the same bound with the operations at half the rate,
since --fmad=false issues each multiply and add alone: regen_render,
grad_render, fused_train_render, stream_render, stream_train,
stream_segment_sum, f64_render, compact_render, group_table and
walk_tables), the nvidia-smi line,
and last {"ok": true, "device": {...}}. Everything measured is
also written to chip_smoke.json in the output directory. Launch counts
are set to 0 just before each main path (phases 4, 7, 8, 10, 12, 13, 14,
16-21, 23-27) and read just after it: each path's own counts are in chip_smoke.json
(launches_by_phase) and their sums are the kernels line's launches; phase
22's ranks count their own launches (each job's, in the worker) and their
sums are added too.
fused_train_render counts its two launches a window (the park render,
then the reverse; one window at the headline), grad_render its reverse,
one a window; stream_segment_sum counts its two kernels (tile_sums_kernel,
then cross_sums_kernel), two per call; stream_train counts walk_counts'
launch too (outside the main paths); walk_tables counts the walk's table
kernel (scan_table_kernel), one launch before each launch of kernels 4
and 5 and walk_counts' (``launch.walk_tables``).
The counts are the port's ``launch.<kernel>`` counters
(``utils/trace.py``). The stream rows' times and bounds
are those of the 100k comparisons in phase 12; the f64 and compact rows'
those of the headline-width comparisons in phases 15 and 17.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# The reference's own CUDA figure at the headline (RTX 3070 Laptop,
# bench.py): the only speed anchor the port keeps.
REFERENCE_HEADLINE_MS = 2879.33
KERNEL_SOURCE = "raytracingincuda_torch/csrc/regen_render.cu"
KERNEL_REPLACES = "raytracingincuda_tpu/ops/pallas_kernel.py:603"
TRAIN_SOURCE = "raytracingincuda_torch/csrc/train_render.cu"
GRAD_REPLACES = "raytracingincuda_tpu/ops/pallas_backward.py:1424"
FUSED_REPLACES = "raytracingincuda_tpu/ops/pallas_backward.py:1464"
# gradient kernels vs plain versions: |kernel - plain| <= GRAD_RTOL |plain|
# + GRAD_ATOL_FRAC max|plain|. The plain versions sum in another order,
# and sums with cancellation leave up to about 2e-5 of the largest entry
# on a small one (measured on the H100).
GRAD_RTOL = 1e-4
GRAD_ATOL_FRAC = 1e-4
# kernel vs plain version on the card: share of quantized components and
# of prepass segments that must be equal
MIN_EXACT = 0.999
STREAM_SOURCE = "raytracingincuda_torch/csrc/stream_render.cu"
STREAM_REPLACES = "raytracingincuda_tpu/ops/pallas_stream.py:504"
STREAM_TRAIN_SOURCE = "raytracingincuda_torch/csrc/stream_train.cu"
STREAM_TRAIN_REPLACES = "raytracingincuda_tpu/ops/pallas_stream_backward.py:92"
SEGMENT_REPLACES = "raytracingincuda_tpu/ops/pallas_stream_backward.py:360"
F64_SOURCE = "raytracingincuda_torch/csrc/f64_render.cu"
F64_REPLACES = "raytracingincuda_tpu/ops/pallas_df64.py:48"
COMPACT_SOURCE = "raytracingincuda_torch/csrc/compact_render.cu"
COMPACT_REPLACES = "raytracingincuda_tpu/ops/pallas_kernel.py:488"
GROUP_TABLE_SOURCE = "raytracingincuda_torch/csrc/group_table.cu"
GROUP_TABLE_REPLACES = "none: the port's own (the two-level scan's table)"
# The reference's own CUDA figure for its double variant at the headline
# (RTX 3070 Laptop, README.md's fp64 table)
REFERENCE_F64_HEADLINE_MS = 40270.4
# The bound: the larger of the operations over the H100's FP32 rate
# outside the tensor cores and the bytes over its memory rate (NVIDIA's
# data sheet, SXM, 700 W). Operations count the function's work once,
# from path_common.cuh: a sphere test is 18 FP32 operations (|C|^2 - r^2
# belongs to the scene, not to the test), and so is a block's bound test;
# each sample is traced once. Only the brute-force hbm render's bound
# (phase 10) counts 25, the test as that kernel computes it. Shading, the
# f64 recipes and the reverse are left out, so each bound is a floor. The
# f64 kernel's sphere tests (18 double operations) count at the FP64 rate.
FP32_PER_S = 67e12
FP64_PER_S = 34e12
BYTES_PER_S = 3.35e12
OPS_TEST_STAGED = 18
OPS_TEST = 25
# the two-level scan's bound test (path_common.cuh: group_can_improve): a
# sphere test's 18, plus widening R by the lane's kPad |o| and forming
# |C|^2 - R^2, which a sphere test takes from the scene
OPS_BOUND_TEST = 26
# the stream walk's group box test (staged_walk.cuh: box_can_improve): six
# operations an axis, two maxima, two minima and three comparisons
OPS_BOX_TEST = 25
# --fmad=false: a multiply and an add are two instructions, so counted
# operations issue at half the FP32 rate (FP64 likewise)
FMAD_OFF = 0.5
SORT_PAIRS = 10
CARD = ""


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}" + (f" | {CARD}" if CARD else ""), flush=True)


def bound(ops: float, nbytes: float, rate: float = FP32_PER_S) -> tuple:
    """(bound_ms, bound_by, the bound with the operations at --fmad=false's
    rate) for this much work, operations at ``rate``."""
    t_ops, t_bytes = ops / rate, nbytes / BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(t_ops / FMAD_OFF, t_bytes) * 1e3)


def profiled_idle(step) -> dict:
    """One call of ``step`` in a torch.profiler window: wall time (CUDA
    events), the device's busy time (the union of the CUDA activity the
    profiler saw), the idle share, and the five names with the most device
    time; busy None when it saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    by_name: dict = {}
    for e in events:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    busy_us, reach = 0.0, float("-inf")
    for a, b in spans:
        if b > reach:
            busy_us += b - max(a, reach)
            reach = b
    busy_ms = busy_us / 1e3 if spans else None
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_events": len(spans),
            "top_device_ms": {name[:60]: ms for name, ms in top},
            "idle_share": None if busy_ms is None
            else max(0.0, 1.0 - busy_ms / wall_ms)}


def fmt_idle(idle: dict) -> str:
    if idle["idle_share"] is None:
        return "not measured (the profiler saw no device activity)"
    top = ", ".join(f"{name[:40]} {ms:.3f}"
                    for name, ms in idle["top_device_ms"].items())
    return (f"{100 * idle['idle_share']:.2f}% ({idle['device_busy_ms']:.2f}"
            f" ms busy of {idle['wall_ms']:.2f} ms; most device ms: {top})")


def timed(fn, reps: int, warm: bool = True, each: bool = False):
    """CUDA-event time of ``fn``, after one warm-up call (``warm``): the
    mean ms of ``reps`` calls in one bracket, or with ``each`` the list of
    ``reps`` per-call times. Returns (the last output, the time)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps if each else 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(1 if each else reps):
            out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return out, (times if each else times[0] / reps)


def grad_compare(kernel_out, plain_out, names) -> dict:
    """Each named gradient of a kernel against its plain version: within
    GRAD_RTOL of the entry plus GRAD_ATOL_FRAC of the largest, finite."""
    import torch

    res = {}
    for name, k, pl in zip(names, kernel_out, plain_out):
        k, pl = k.float(), pl.float()
        scale = float(pl.abs().max())
        err = float((k - pl).abs().max())
        ok = bool(torch.isfinite(k).all()) and bool(torch.allclose(
            k, pl, rtol=GRAD_RTOL, atol=GRAD_ATOL_FRAC * max(scale, 1e-30)))
        res[name] = {"max_abs_err": err, "max_rel_to_largest":
                     err / max(scale, 1e-30), "ok": ok}
    return res


def sampled_lanes(padded: int, n_last: int, n_drawn: int, seed: int, dev):
    """Lane indices, sorted: the image's last ``n_last`` lanes and
    ``n_drawn`` drawn from the other lanes at 2^24 and above."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    drawn = rng.choice(padded - n_last - (1 << 24), n_drawn,
                       replace=False) + (1 << 24)
    pick = np.concatenate([np.arange(padded - n_last, padded), drawn])
    return torch.from_numpy(np.sort(pick)).to(dev)


def large_images(dev, cam, reset_counts, read_counts) -> dict:
    """Phase 26: images of 2^24 pixels and more on every kernel route (the
    port's lanes stopped below 2^24 before), each kernel held to its plain
    version on sampled lanes at pixel ids >= 2^24. Returns the record."""
    import numpy as np
    import torch

    from raytracingincuda_torch.config import RenderConfig
    from raytracingincuda_torch.models.camera import config_leaves, initialize
    from raytracingincuda_torch.models.scene import (build_random_scene,
                                                     build_scene, param_leaves)
    from raytracingincuda_torch.ops import adaptive
    from raytracingincuda_torch.ops import f64_kernel as fk
    from raytracingincuda_torch.ops import grad as gradlib
    from raytracingincuda_torch.ops import kernel_io as kio
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import stream_kernel as sk
    from raytracingincuda_torch.ops import stream_train_kernel as stk
    from raytracingincuda_torch.ops import train_kernel as tk
    from raytracingincuda_torch.ops.tracer import linear_to_gamma
    from raytracingincuda_torch.render_api import make_renderer
    from raytracingincuda_torch.utils import ppm

    phase = "26 large images"
    t_phase = time.perf_counter()
    out: dict = {}
    scene1 = build_scene(1, device=dev)
    n1 = scene1.num_slots

    def peak_since(base):
        return torch.cuda.max_memory_allocated() / 2**20 - base

    def fresh_peak():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated() / 2**20

    # kernel 1 through make_renderer at 8K UHD, parity, scene 1
    w8, h8, spp8, d8 = 7680, 4320, 4, 25
    n8 = w8 * h8
    renderer = make_renderer(RenderConfig(scene_id=1, width=w8, height=h8,
                                          samples=spp8, bounces=d8), dev)
    base = fresh_peak()
    reset_counts()
    img8, times8 = timed(lambda: renderer(scene1, cam), 3, each=True)
    counts8 = read_counts("26 8K UHD render (7680x4320x4spp/25b)")
    peak8 = peak_since(base)
    inputs8 = rk.regen_inputs(scene1, cam, w8, h8, spp8)
    sel8 = sampled_lanes(n8, 8192, 8192, 26, dev)
    sub8 = tuple(t[sel8].contiguous() for t in inputs8[:4])
    plain8, plain8_ms = timed(lambda: rk.regen_reference(
        *sub8, *inputs8[4:], samples=spp8, max_depth=d8,
        finalize_scale=1.0 / spp8), 1, warm=False)
    got8 = img8.reshape(-1, 3)[sel8].t()
    # the count mode: segments per lane, and the warps' hit-test issues
    # against their lanes' mean (a warp runs until its longest lane ends)
    seg_lane, issues, *_ = rk.regen_counts(*inputs8, samples=spp8, max_depth=d8)
    segs8 = float(seg_lane.double().sum())
    issues_over_mean = float(issues.double().sum()) / float(
        seg_lane.double().view(-1, 32).mean(1).sum())
    del seg_lane, issues, inputs8, sub8
    t0 = time.perf_counter()
    arr8 = img8.cpu().numpy()
    copy_s = time.perf_counter() - t0
    render8 = {"shape": f"{w8}x{h8}x{spp8}spp/{d8}b", "render_ms": times8,
               "launches": {k: v for k, v in counts8.items() if v},
               "peak_over_base_mib": peak8,
               "sampled_lanes": int(sel8.numel()),
               "min_sampled_id": int(sel8.min()),
               "bit_equal_to_plain": bool(torch.equal(got8, plain8)),
               "max_abs_err": float((got8 - plain8).abs().max()),
               "plain_ms_on_sampled_lanes": plain8_ms,
               "segments": segs8, "issues_over_mean": issues_over_mean,
               "bound": bound(segs8 * n1 * OPS_TEST_STAGED,
                              n8 * 28 + n1 * kio.USED_COLS * 4 + 96)}
    if not (render8["bit_equal_to_plain"] and counts8["regen_render"] == 4
            and arr8.shape == (h8, w8, 3) and np.isfinite(arr8).all()
            and 0.0 <= arr8.min() and arr8.max() <= 1.0):
        raise AssertionError(f"8K render: {render8}")
    say(phase, f"make_renderer {render8['shape']} parity (kernel 1, "
        f"{n8} lanes): render_ms {', '.join(f'{t:.2f}' for t in times8)};"
        f" bound {render8['bound'][0]:.3f} ms ({render8['bound'][1]}); the "
        f"warps issue the scan {issues_over_mean:.3f}x their lanes' mean "
        f"segments; peak "
        f"{peak8:.1f} MiB above the {base:.1f} MiB held before; "
        f"{sel8.numel()} sampled lanes (ids >= {int(sel8.min())}, the last "
        f"8192 among them) bit-equal to regen_reference "
        f"({plain8_ms:.1f} ms there)")

    # the PPM writer at 8K, then the CLI at the same config: its bytes
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ppm.write_ppm(os.path.join(tmp, "phase.ppm"), arr8)
        write_s = time.perf_counter() - t0
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        cli_out = os.path.join(tmp, "cli")
        os.mkdir(cli_out)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "raytracingincuda_torch.cli", "--scene_id",
             "1", "--width", str(w8), "--height", str(h8), "--samples",
             str(spp8), "--bounces", str(d8), "--outdir", cli_out],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"8K cli failed: {res.stderr[-2000:]}")
        line = res.stdout.strip().splitlines()[-1]
        render_ms, e2e_ms = (float(v) for v in line.split(","))
        (name,) = os.listdir(cli_out)
        with open(os.path.join(cli_out, name), "rb") as f:
            data = f.read()
        header = f"P3\n{w8} {h8}\n255\n".encode()
        lines = data.count(b"\n") - 3
        with open(os.path.join(tmp, "phase.ppm"), "rb") as f:
            same = f.read() == data
        cli8 = {"render_ms": render_ms, "e2e_ms": e2e_ms, "file": name,
                "bytes": len(data), "pixels": lines,
                "header_ok": data.startswith(header),
                "equal_to_phase_write": same, "process_s": cli_s,
                "write_ppm_s": write_s, "device_to_host_s": copy_s}
        del data
    if not (cli8["pixels"] == n8 and cli8["header_ok"] and same):
        raise AssertionError(f"8K cli: {cli8}")
    say(phase, f"cli --width {w8} --height {h8} --samples {spp8}: "
        f"render_ms,e2e_ms {render_ms:.2f},{e2e_ms:.2f}; its PPM holds "
        f"{lines} pixels ({cli8['bytes']} bytes), the bytes of write_ppm on "
        f"the image above (write_ppm {write_s:.2f} s, the copy to the host "
        f"{copy_s:.2f} s); the process took {cli_s:.1f} s")
    del img8, arr8

    # kernel 2 through make_mse_train at 4096x4104x2spp/25b rr2. The
    # target is kernel 1's image but on sampled lanes >= 2^24; the step's
    # image equals kernel 1's, so the loss's cotangent is exactly zero
    # elsewhere and the step's gradients are those lanes' alone
    w, h, spp, depth = 4096, 4104, 2, 25
    n = w * h
    gen = torch.Generator().manual_seed(26)
    img1 = rk.render_kernel(scene1, cam, w, h, spp, depth, rr_start=2)
    sel = sampled_lanes(n, 8192, 8192, 27, dev)
    target = img1.reshape(-1, 3).clone()
    target[sel] = torch.rand((sel.numel(), 3), generator=gen).to(dev)
    target = target.reshape(h, w, 3)
    step = tk.make_mse_train(scene1.mat_type, scene1.active, w, h, spp,
                             depth, rr_start=2)
    plan = tk.plan_park(n, spp, depth, n1)
    base = fresh_peak()
    reset_counts()
    (loss, img, grads), step_ms = timed(
        lambda: step(scene1.params, cam, target), 3, each=True)
    train_counts = read_counts("26 train step (4096x4104x2spp/25b rr2)")
    train_peak = peak_since(base)
    ids, ii, jj, _, sm, row = rk.regen_inputs(scene1, cam, w, h, spp)
    sub = (ids[sel].contiguous(), ii[sel].contiguous(), jj[sel].contiguous())
    t_rows = target.reshape(-1, 3)[sel].t().contiguous()
    (p_terms, _, p_scene, p_cam), p2_ms = timed(
        lambda: tk.fused_train_reference(
            *sub, t_rows, sm, row, samples=spp, max_depth=depth,
            num_pixels=n, rr_start=2), 1, warm=False)
    p_grads = tk.chain_to_params(p_scene, p_cam, scene1.params, cam,
                                 scene1.mat_type, scene1.active, w, h)
    p_loss = p_terms * tk.loss_constants(spp, n, 1.0)["w"]

    def flat(g):
        return (torch.stack(param_leaves(g[0])), torch.stack(
            [torch.as_tensor(x, dtype=torch.float32, device=dev)
             for x in config_leaves(g[1])]))

    train = {"shape": f"{w}x{h}x{spp}spp/{depth}b rr2", "step_ms": step_ms,
             "loss_value": float(loss), "park_windows": len(plan.windows),
             "park_capacity": plan.capacity,
             "acc_in_smem": plan.acc_in_smem,
             "launches": {k: v for k, v in train_counts.items() if v},
             "peak_over_base_mib": train_peak,
             "image_equals_kernel1": bool(torch.equal(img, img1)),
             "plain_ms_on_sampled_lanes": p2_ms,
             **grad_compare((loss.reshape(1), *flat(grads)),
                            (p_loss.reshape(1), *flat(p_grads)),
                            ("loss", "d_params", "d_cam_cfg"))}
    if not (train["image_equals_kernel1"] and train["loss"]["ok"]
            and train["d_params"]["ok"] and train["d_cam_cfg"]["ok"]
            and train_counts["fused_train_render"] == 8 * len(plan.windows)):
        raise AssertionError(f"large train step: {train}")
    del img, img1, grads, p_grads, target
    say(phase, f"make_mse_train {train['shape']}: {len(plan.windows)} park "
        f"windows of capacity {plan.capacity}; step ms "
        f"{', '.join(f'{t:.2f}' for t in step_ms)}; peak {train_peak:.1f} MiB"
        f"; image bit-equal to kernel 1's; the target kernel 1's image but on"
        f" {sel.numel()} sampled lanes >= 2^24: against fused_train_reference"
        f" there ({p2_ms:.1f} ms) loss rel "
        f"{train['loss']['max_rel_to_largest']:.3g}, d_params max|d|/max "
        f"{train['d_params']['max_rel_to_largest']:.3g}, d_cam_cfg "
        f"{train['d_cam_cfg']['max_rel_to_largest']:.3g}; launches "
        f"{train['launches']}")
    # kernel 3 with g zero but on the sampled lanes
    g_sel = (torch.randn((3, sel.numel()), generator=gen) * 1e-3).to(dev)
    g_img = torch.zeros((n, 3), device=dev)
    g_img[sel] = g_sel.t()
    reset_counts()
    k3, k3_ms = timed(lambda: tk.render_kernel_grads(
        scene1, cam, g_img.reshape(h, w, 3), w, h, spp, depth, rr_start=2),
        1, warm=False)
    k3_counts = read_counts("26 render_kernel_grads (4096x4104x2spp/25b)")
    p3, p3_ms = timed(lambda: tk.grad_reference(
        *sub, g_sel, sm, row, samples=spp, max_depth=depth, rr_start=2), 1,
        warm=False)
    grad3 = {"kernel_ms": k3_ms, "plain_ms_on_sampled_lanes": p3_ms,
             "launches": {k: v for k, v in k3_counts.items() if v},
             **grad_compare(k3, p3, ("d_scene", "d_cam"))}
    if not (grad3["d_scene"]["ok"] and grad3["d_cam"]["ok"]
            and k3_counts["grad_render"] >= 1):
        raise AssertionError(f"kernel 3 on sampled lanes: {grad3}")
    say(phase, f"render_kernel_grads (kernel 3) at {w}x{h}x{spp}spp/{depth}b "
        f"rr2 with g zero but on {sel.numel()} sampled lanes >= 2^24: "
        f"{k3_ms:.2f} ms; against grad_reference on those lanes "
        f"({p3_ms:.1f} ms): d_scene max|d|/max "
        f"{grad3['d_scene']['max_rel_to_largest']:.3g}, d_cam "
        f"{grad3['d_cam']['max_rel_to_largest']:.3g}")
    del ids, ii, jj, g_img, k3, sub

    # kernels 4 and 5 on the 100k scene at 4096x4104x1spp/10b
    s100k = build_random_scene(100_000, seed=3, device=dev)
    spp_s, d_s = 1, 10
    srender = make_renderer(RenderConfig(scene_id=0, width=w, height=h,
                                         samples=spp_s, bounces=d_s,
                                         impl="stream"), dev)
    st = srender.prepare(s100k, cam)
    base = fresh_peak()
    reset_counts()
    simg, s_ms = timed(lambda: srender(s100k, cam), 3, each=True)
    s_counts = read_counts("26 stream render (100k, 4096x4104x1spp/10b)")
    s_peak = peak_since(base)
    ssel = sampled_lanes(n, 2048, 2048, 28, dev)
    sids, sii, sjj, sbud = kio.lane_setup(w, h, None, spp_s, 0, None, dev)
    srow = rk.pack_camera(initialize(cam, w, h)).to(dev)
    sub = tuple(t[ssel].contiguous() for t in (sids, sii, sjj, sbud))
    sp, sp_ms = timed(lambda: sk.stream_reference(
        *sub, st.scene_mat, st.bounds, srow, block=st.block, samples=spp_s,
        max_depth=d_s, finalize_scale=1.0 / spp_s), 1, warm=False)
    sgot = simg.reshape(-1, 3)[ssel].t()
    stream4 = {"render_ms": s_ms, "peak_over_base_mib": s_peak,
               "launches": {k: v for k, v in s_counts.items() if v},
               "bit_equal_to_plain": bool(torch.equal(sgot, sp)),
               "max_abs_err": float((sgot - sp).abs().max()),
               "plain_ms_on_sampled_lanes": sp_ms}
    if not (stream4["bit_equal_to_plain"] and s_counts["stream_render"] == 4):
        raise AssertionError(f"stream render at 4096x4104: {stream4}")
    say(phase, f"make_renderer(impl='stream') 100k {w}x{h}x{spp_s}spp/{d_s}b"
        f" (kernel 4): render_ms {', '.join(f'{t:.2f}' for t in s_ms)}; "
        f"peak {s_peak:.1f} MiB; {ssel.numel()} sampled lanes bit-equal to "
        f"stream_reference ({sp_ms:.1f} ms there)")
    del simg
    windows = stk.plan_records(n, spp_s, d_s)
    sg_sel = (torch.randn((3, ssel.numel()), generator=gen) * 1e-3).to(dev)
    sg_img = torch.zeros((n, 3), device=dev)
    sg_img[ssel] = sg_sel.t()
    reset_counts()
    k5, k5_ms = timed(lambda: stk.render_stream_grads(
        st, cam, sg_img.reshape(h, w, 3), w, h, spp_s, d_s), 1, warm=False)
    k5_counts = read_counts("26 render_stream_grads (100k, 4096x4104)")
    p5, p5_ms = timed(lambda: stk.stream_grads_reference(
        *sub[:3], sg_sel, st.scene_mat, st.bounds, srow, block=st.block,
        samples=spp_s, max_depth=d_s), 1, warm=False)
    grad5 = {"windows": len(windows), "kernel_ms": k5_ms,
             "plain_ms_on_sampled_lanes": p5_ms,
             "launches": {k: v for k, v in k5_counts.items() if v},
             **grad_compare(k5, p5, ("d_stream", "d_cam"))}
    if not (grad5["d_stream"]["ok"] and grad5["d_cam"]["ok"]
            and k5_counts["stream_train"] == len(windows)
            and all(x.lanes < n for x in windows)):
        raise AssertionError(f"kernel 5 at 4096x4104: {grad5}")
    say(phase, f"render_stream_grads (kernel 5) at 100k {w}x{h}x{spp_s}spp/"
        f"{d_s}b in {len(windows)} lane-chunk record windows, g zero but on "
        f"{ssel.numel()} sampled lanes: {k5_ms:.2f} ms; against "
        f"stream_grads_reference on those lanes ({p5_ms:.1f} ms): d_stream "
        f"max|d|/max {grad5['d_stream']['max_rel_to_largest']:.3g}, d_cam "
        f"{grad5['d_cam']['max_rel_to_largest']:.3g}")
    del sg_img, k5, sids, sii, sjj, sbud
    init_fn, step_fn = gradlib.make_stream_train(st, w, h, spp_s, d_s)
    state0 = init_fn(s100k.params)
    starget = torch.rand((h, w, 3), generator=gen).to(dev)
    base = fresh_peak()
    reset_counts()
    (state, sloss), sstep_ms = timed(lambda: step_fn(
        state0, cam, s100k.mat_type, s100k.active, starget), 2, each=True)
    ss_counts = read_counts("26 stream train step (100k, 4096x4104)")
    ss_peak = peak_since(base)
    sstep = {"step_ms": sstep_ms, "loss": float(sloss),
             "windows": len(windows), "peak_over_base_mib": ss_peak,
             "launches": {k: v for k, v in ss_counts.items() if v}}
    if not (np.isfinite(sstep["loss"])
            and ss_counts["stream_train"] == 3 * len(windows)
            and ss_counts["stream_render"] == 3):
        raise AssertionError(f"stream step at 4096x4104: {sstep}")
    say(phase, f"make_stream_train 100k {w}x{h}x{spp_s}spp/{d_s}b: "
        f"{len(windows)} windows; step ms "
        f"{', '.join(f'{t:.2f}' for t in sstep_ms)}; peak {ss_peak:.1f} MiB;"
        f" loss {sstep['loss']:.9g}; launches {sstep['launches']}")
    del state, state0, starget, s100k, st

    # kernel 6 through make_renderer(dtype='float64') at 4096x4104x1spp/8b
    f_spp, f_d = 1, 8
    frender = make_renderer(RenderConfig(scene_id=1, width=w, height=h,
                                         samples=f_spp, bounces=f_d,
                                         dtype="float64"), dev)
    reset_counts()
    fimg, f_ms = timed(lambda: frender(scene1, cam), 3, each=True)
    f_counts = read_counts("26 f64 render (4096x4104x1spp/8b)")
    fids, fii, fjj, fsm, frow = fk.f64_inputs(scene1, cam, w, h)
    fp, fp_ms = timed(lambda: fk.f64_reference(
        fids[sel].contiguous(), fii[sel].contiguous(), fjj[sel].contiguous(),
        fsm, frow, samples=f_spp, max_depth=f_d), 1, warm=False)
    fp = fk.finalize(fp.t(), f_spp)
    fgot = fimg.reshape(-1, 3)[sel]
    f64 = {"render_ms": f_ms, "plain_ms_on_sampled_lanes": fp_ms,
           "launches": {k: v for k, v in f_counts.items() if v},
           "bit_equal_to_plain": bool(torch.equal(fgot, fp)),
           "max_abs_err": float((fgot - fp).abs().max())}
    if not (f64["bit_equal_to_plain"] and f_counts["f64_render"] == 4
            and fimg.dtype == torch.float64 and bool(
                torch.isfinite(fimg).all())):
        raise AssertionError(f"f64 at 4096x4104: {f64}")
    say(phase, f"make_renderer(dtype='float64') {w}x{h}x{f_spp}spp/{f_d}b "
        f"(kernel 6): render_ms {', '.join(f'{t:.2f}' for t in f_ms)}; its "
        f"image on {sel.numel()} sampled lanes bit-equal to f64_reference's "
        f"({fp_ms:.1f} ms there)")
    del fimg, fids, fii, fjj

    # the adaptive route (kernel 1 with budget rows), base 4, max 16; its
    # image on the sampled lanes against regen_reference's sums of the
    # probe's two half-buffers and of the refine at the same budgets
    a_base, a_max = 4, 16
    arender = make_renderer(RenderConfig(scene_id=1, width=w, height=h,
                                         samples=a_base, bounces=d8,
                                         impl="adaptive",
                                         max_samples=a_max), dev)
    base = fresh_peak()
    reset_counts()
    aimg, a_ms = timed(lambda: arender(scene1, cam), 1, warm=False)
    a_counts = read_counts("26 adaptive (4096x4104, base 4, max 16)")
    a_peak = peak_since(base)
    spp_map = adaptive.render_adaptive(scene1, cam, w, h, d8, base_spp=a_base,
                                       max_spp=a_max, tol=0.05).spp_map
    extra = (spp_map - a_base).reshape(-1)
    (r_spp, r_off), = adaptive.sample_windows(a_base, a_max, 1)[0]

    def plain_sums(samples, offset, budgets=None):
        inp = rk.regen_inputs(scene1, cam, w, h, samples,
                              sample_offset=offset, sample_budgets=budgets)
        return rk.regen_reference(
            *(t[sel].contiguous() for t in inp[:4]), *inp[4:],
            samples=samples, max_depth=d8, sample_offset=offset).t()

    half = a_base // 2
    pa = plain_sums(half, 0)
    pb = plain_sums(half, half)
    pc, pc_ms = timed(lambda: plain_sums(r_spp, r_off, extra), 1, warm=False)
    counts = spp_map.reshape(-1)[sel]
    aplain = linear_to_gamma(((pa + pc) + pb) / counts[:, None].float())
    aget = aimg.reshape(-1, 3)[sel]
    adapt = {"render_ms": a_ms, "peak_over_base_mib": a_peak,
             "launches": {k: v for k, v in a_counts.items() if v},
             "mean_spp": float(spp_map.double().mean()),
             "spp_range": [int(spp_map.min()), int(spp_map.max())],
             "sampled_lanes_refined": int((counts > a_base).sum()),
             "sampled_spp_range": [int(counts.min()), int(counts.max())],
             "bit_equal_to_plain": bool(torch.equal(aget, aplain)),
             "max_abs_err": float((aget - aplain).abs().max()),
             "plain_refine_ms_on_sampled_lanes": pc_ms}
    if not (adapt["bit_equal_to_plain"]
            and a_base <= adapt["spp_range"][0] <= adapt["spp_range"][1]
            <= a_max and a_counts["regen_render"] == 3
            and adapt["sampled_lanes_refined"] > 0
            and bool(torch.isfinite(aimg).all())):
        raise AssertionError(f"adaptive at 4096x4104: {adapt}")
    say(phase, f"make_renderer(impl='adaptive') {w}x{h}/{d8}b base {a_base} "
        f"max {a_max}: {a_ms:.2f} ms; mean spp {adapt['mean_spp']:.3f} in "
        f"{adapt['spp_range']}; its image on {sel.numel()} sampled lanes "
        f"({adapt['sampled_lanes_refined']} refined, spp in "
        f"{adapt['sampled_spp_range']}) bit-equal to "
        f"regen_reference's at the same budgets ({pc_ms:.1f} ms for the "
        f"refine there); peak {a_peak:.1f} MiB; launches {adapt['launches']}")
    out.update(render_8k=render8, cli_8k=cli8, train=train, grad3=grad3,
               stream_render=stream4, stream_grads=grad5,
               stream_step=sstep, f64=f64, adaptive=adapt)
    out["phase_s"] = time.perf_counter() - t_phase
    say(phase, f"phase took {out['phase_s']:.1f} s")
    return out


def default_scenes(dev, cam, reset_counts, read_counts) -> dict:
    """Phase 27: scenes built with no ``device`` land on the card, and the
    kernels render them there. ``build_scene(1)`` goes through
    ``render_kernel`` (kernel 1) and ``build_random_scene(10_000, seed=3)``
    through ``render_stream`` (kernel 4) at 320x192x2spp/8b; each image
    is bit-equal to the same render of the scene built with ``device=dev``.
    Returns the record."""
    import torch

    from raytracingincuda_torch.models.scene import (build_random_scene,
                                                     build_scene, param_leaves)
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import stream_kernel as sk

    phase = "27 defaults"
    t_phase = time.perf_counter()
    w, h, spp, depth = 320, 192, 2, 8

    def on_card(scene) -> bool:
        return all(t.is_cuda for t in (*param_leaves(scene.params),
                                       scene.mat_type, scene.active))

    def renders(s1, s10k):
        return (rk.render_kernel(s1, cam, w, h, spp, depth),
                sk.render_stream(sk.prepare_stream_scene(s10k), cam, w, h,
                                 spp, depth))

    s1, s10k = build_scene(1), build_random_scene(10_000, seed=3)
    placed = {"scene1": on_card(s1), "random_10k": on_card(s10k)}
    if not all(placed.values()):
        raise AssertionError(f"default scenes off the card: {placed}")
    reset_counts()
    img1, img4 = renders(s1, s10k)
    torch.cuda.synchronize()
    counts = read_counts(phase)
    want1, want4 = renders(build_scene(1, device=dev),
                           build_random_scene(10_000, seed=3, device=dev))
    out = {"on_card": placed, "launches": counts,
           "kernel1_bit_equal": bool(torch.equal(img1, want1)),
           "kernel4_bit_equal": bool(torch.equal(img4, want4)),
           "finite": bool(torch.isfinite(img1).all()
                          and torch.isfinite(img4).all())}
    if not (counts["regen_render"] >= 1 and counts["stream_render"] >= 1
            and out["kernel1_bit_equal"] and out["kernel4_bit_equal"]
            and out["finite"] and img1.is_cuda and img4.is_cuda):
        raise AssertionError(f"default-device renders: {out}")
    out["phase_s"] = time.perf_counter() - t_phase
    say(phase, f"build_scene(1) and build_random_scene(10_000) with no "
        f"device on {s1.mat_type.device}; render_kernel and render_stream "
        f"at {w}x{h}x{spp}spp/{depth}b launched {counts}, images bit-equal "
        f"to device={dev}'s; phase took {out['phase_s']:.1f} s")
    return out


def group_tables(dev, cam, reset_counts, read_counts) -> dict:
    """Phase 28: the two-level scan's group table (``csrc/group_table.cu``)
    on the card against its plain twin ``group_table_reference``, word for
    word, at the main path's inputs (scene 1's 512 slots, the headline's
    camera row at 1280x768) and after three fused train steps of
    ``make_train_step`` (96x58x4spp/6b, centres and radii trained) moved
    the scene; its device time (the profiler's, 20 launches), the twin's
    time and its bound. Returns the record."""
    import torch

    from raytracingincuda_torch.models.scene import (Scene, SceneParams,
                                                     build_scene)
    from raytracingincuda_torch.ops import grad as gradlib
    from raytracingincuda_torch.ops import group_scan as gs
    from raytracingincuda_torch.ops import kernel_io as kio
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops.vec import Vec3

    phase = "28 group table"
    t_phase = time.perf_counter()
    scene = build_scene(1, device=dev)
    row = rk.regen_inputs(scene, cam, 1280, 768, 1)[5]

    @torch.no_grad()
    def table_pair(sc):
        sm = rk.pack_scene_matrix(sc)
        soa = kio.soa(sm)
        got = gs.group_table_kernel(soa, row)
        want = gs.group_table_reference(sm, row)
        return sm, soa, got, want

    reset_counts()
    sm, soa, got, want = table_pair(scene)
    torch.cuda.synchronize()
    counts = read_counts(phase)
    head = gs.unpack(got, sm.shape[0])
    # three train steps over centres and radii move the scene
    trainable = SceneParams(Vec3(True, True, True), True,
                            Vec3(False, False, False), False, False)
    init_fn, step_fn = gradlib.make_train_step(
        96, 58, 4, 6, learning_rate=2e-2, impl="fused", trainable=trainable)
    gen = torch.Generator().manual_seed(28)
    target = torch.rand((58, 96, 3), generator=gen).to(dev)
    state = init_fn(scene.params)
    for _ in range(3):
        state, _ = step_fn(state, cam, scene.mat_type, scene.active, target)
    moved_scene = Scene(state.params, scene.mat_type, scene.active)
    sm2, soa2, got2, want2 = table_pair(moved_scene)
    moved = int((sm2[:, 0:4] != sm[:, 0:4]).any(1).sum())
    # device time of one launch, the twin's, and the bound: the scene's
    # columns read, the camera row read and the table written; operations
    # |C|^2 - r^2 a slot (7), below the bytes' time
    n = sm.shape[0]
    idle = profiled_idle(lambda: [gs.group_table_kernel(soa, row)
                                  for _ in range(20)])
    dev_ms = sum(ms for name, ms in idle["top_device_ms"].items()
                 if "group_table" in name)
    kernel_ms = dev_ms / 20 if dev_ms else timed(
        lambda: gs.group_table_kernel(soa, row), 20)[1]
    _, plain_ms = timed(lambda: gs.group_table_reference(sm, row), 1)
    bnd = bound(7 * n, (kio.USED_COLS * n + row.numel()
                        + gs.table_words(n)) * 4)
    out = {"slots": n, "launches": counts,
           "equal": bool(torch.equal(got.cpu(), want.cpu())),
           "moved_slots": moved,
           "moved_equal": bool(torch.equal(got2.cpu(), want2.cpu())),
           "moved_table_differs": not bool(torch.equal(got2.cpu(),
                                                       got.cpu())),
           "large": head.large, "small": head.small,
           "groups": head.n_groups,
           "kernel_ms": kernel_ms, "kernel_ms_from": "profiler" if dev_ms
           else "events", "plain_ms": plain_ms,
           "bound": bnd}
    if not (out["equal"] and out["moved_equal"] and moved > 0
            and out["moved_table_differs"] and counts["group_table"] == 1):
        raise AssertionError(f"group table on the card: {out}")
    out["phase_s"] = time.perf_counter() - t_phase
    say(phase, f"scene 1 ({n} slots: {head.large} large, {head.small} small "
        f"in {head.n_groups} groups) at the headline's camera row: the "
        f"card's table equals the twin word for word; after 3 train steps "
        f"moved {moved} slots, equal again (and unlike the first) | kernel "
        f"{kernel_ms * 1e3:.2f} us ({out['kernel_ms_from']}), plain "
        f"{plain_ms:.2f} ms, bound {bnd[0] * 1e3:.4f} us ({bnd[1]}); phase "
        f"took {out['phase_s']:.1f} s")
    return out


def walk_tables(st) -> dict:
    """Kernels 4 and 5's tables (``csrc/staged_walk.cuh``'s
    ``scan_table_kernel``, the launch before every walk) built on the card
    from stream ``st``, against their plain twin (``walk_groups_reference``)
    word for word; the launch's device time (the profiler's, 20 launches),
    the twin's time and the bound (bytes: five columns read a row, the scan
    table and the group table written). Returns the record."""
    import torch

    from raytracingincuda_torch.ops import stream_kernel as sk

    rows, block = st.scene_mat.shape[0], st.block
    _, groups = sk.walk_tables_kernel(st.scene_mat, block)
    want, plain_ms = timed(lambda: sk.walk_groups_reference(st.scene_mat,
                                                            block), 1)
    idle = profiled_idle(lambda: [sk.walk_tables_kernel(st.scene_mat, block)
                                  for _ in range(20)])
    dev_ms = sum(ms for name, ms in idle["top_device_ms"].items()
                 if "scan_table_kernel" in name)
    kernel_ms = dev_ms / 20 if dev_ms else timed(
        lambda: sk.walk_tables_kernel(st.scene_mat, block), 20)[1]
    n_groups = groups.shape[0]
    out = {"rows": rows, "block": block, "groups": n_groups,
           "equal": bool(torch.equal(groups.cpu().view(torch.int32),
                                     want.cpu().view(torch.int32))),
           "kernel_ms": kernel_ms,
           "kernel_ms_from": "profiler" if dev_ms else "events",
           "plain_ms": plain_ms,
           "bound": bound(0, rows * 5 * 4 + rows * 16 + n_groups * 32)}
    if not out["equal"]:
        raise AssertionError(f"the walk's group table on the card: {out}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's main path needs one", file=sys.stderr)
        return 2

    import numpy as np

    from raytracingincuda_torch.config import RenderConfig
    from raytracingincuda_torch.models.camera import (CameraConfig,
                                                      config_leaves)
    from raytracingincuda_torch.models.scene import build_scene, param_leaves
    from raytracingincuda_torch.ops import _build
    from raytracingincuda_torch.ops import compact_kernel as ck
    from raytracingincuda_torch.ops import f64_kernel as fk
    from raytracingincuda_torch.ops import kernel_io as kio
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import stream_kernel as sk
    from raytracingincuda_torch.ops import stream_train_kernel as stk
    from raytracingincuda_torch.ops import train_kernel as tk
    from raytracingincuda_torch.render_api import make_renderer
    from raytracingincuda_torch.utils import ppm
    from raytracingincuda_torch.utils import trace
    from raytracingincuda_torch.utils.timing import RenderTimer, device_record

    global CARD
    dev = torch.device("cuda")
    record: dict = {}
    cam = CameraConfig.reference_default()
    kernels = ("regen_render", "grad_render", "fused_train_render",
               "stream_render", "stream_train", "stream_segment_sum",
               "f64_render", "compact_render", "group_table", "walk_tables")
    main_launches = {name: 0 for name in kernels}
    record["launches_by_phase"] = {}

    def reset_counts():
        trace.reset()

    def read_counts(path: str) -> dict:
        """The launches counted since the last reset (``launch.<kernel>``),
        kept under this main path's name and added to the kernels line's
        sums."""
        got = trace.counts()
        got = {name: got.get(f"launch.{name}", 0) for name in kernels}
        for name, n in got.items():
            main_launches[name] += n
        record["launches_by_phase"][path] = nonzero(got)
        return got

    def nonzero(counts: dict) -> dict:
        return {k: v for k, v in counts.items() if v}

    # -- 0 device ------------------------------------------------------------
    rec = device_record()
    record["device"] = rec
    say("0 device", f"{rec['name_power_limit']} | torch {torch.__version__} "
        f"cuda {rec['torch_cuda']} | driver {rec['driver']} | "
        f"{rec['count']} device(s)")
    CARD = rec["name_power_limit"]

    # -- 1 build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    record["build_s"] = build_s
    say("1 build", f"{_build.library_path().name} in {build_s:.2f} s "
        f"({' '.join(_build.NVCC_FLAGS)})")

    # -- 2 goldens -----------------------------------------------------------
    golden_dir = ROOT / "tests" / "golden"
    record["goldens"] = {}
    for sid in (1, 2, 3):
        img = rk.render_kernel(build_scene(sid, device=dev), cam, 48, 30, 4, 8)
        golden, _ = ppm.read_ppm(str(golden_dir / f"scene{sid}_48x30_4spp_8b.ppm"))
        st = ppm.diff_stats(img.cpu().numpy(), golden)
        record["goldens"][f"scene{sid}_48x30_4spp_8b"] = st
        if not ppm.passes_cross_framework_gate(st):
            raise AssertionError(f"scene {sid} 48x30 golden gate failed: {st}")
        cfg = RenderConfig(scene_id=sid, width=64, height=40, samples=8,
                           bounces=6, rr_start=2)
        img = make_renderer(cfg, dev)(build_scene(sid, device=dev), cam)
        golden, _ = ppm.read_ppm(
            str(golden_dir / f"scene{sid}_prod_64x40_8spp_6b_rr2.ppm"))
        st = ppm.diff_stats(img.cpu().numpy(), golden)
        record["goldens"][f"scene{sid}_prod_64x40_8spp_6b_rr2"] = st
        if not ppm.passes_cross_framework_gate(st):
            raise AssertionError(f"scene {sid} prod golden gate failed: {st}")
    worst = min(v["within1"] for v in record["goldens"].values())
    say("2 goldens", f"6/6 pass the cross-framework gate "
        f"{ppm.CROSS_FRAMEWORK_GATE}; worst within-1 share {worst:.4f}; "
        f"exact shares "
        + ", ".join(f"{k.split('_')[0]}{'p' if 'prod' in k else ''}="
                    f"{v['exact']:.4f}" for k, v in record["goldens"].items()))

    # -- 3 kernel vs plain version ------------------------------------------
    def compare(width, height, spp, bounces, rr, layout, reps, plain=None):
        scene = build_scene(1, device=dev)
        inputs = rk.regen_inputs(scene, cam, width, height, spp)
        kw = dict(samples=spp, max_depth=bounces, rr_start=rr,
                  finalize_scale=1.0 / spp, layout=layout)
        k_out, k_ms = timed(lambda: rk.regen_kernel(*inputs, **kw), reps)
        again = rk.regen_kernel(*inputs, **kw)
        if plain is None:
            plain = timed(lambda: rk.regen_reference(*inputs, **kw), 1,
                          warm=False)
        p_out, p_ms = plain
        k_np, p_np = k_out.cpu().numpy(), p_out.cpu().numpy()
        res = {
            "shape": f"{width}x{height}x{spp}spp/{bounces}b",
            "rr_start": rr, "layout": layout,
            "max_abs_err": float(np.abs(k_np - p_np).max()),
            "exact_quantized": float((ppm.quantize(k_np)
                                      == ppm.quantize(p_np)).mean()),
            "bit_equal": bool(torch.equal(k_out, p_out)),
            "run_to_run_identical": bool(torch.equal(k_out, again)),
            "kernel_ms": k_ms, "plain_ms": p_ms,
        }
        if not (np.isfinite(k_np).all() and res["run_to_run_identical"]
                and res["exact_quantized"] > MIN_EXACT):
            raise AssertionError(f"kernel vs plain failed: {res}")
        return res, plain

    record["compare"] = []
    for rr in (None, 2):
        plain = None
        for layout in ("vmem", "hbm"):
            res, plain = compare(320, 192, 10, 25, rr, layout, 5, plain)
            record["compare"].append(res)
            say("3 compare", f"{res['shape']} rr={rr} {layout}: max|d| "
                f"{res['max_abs_err']:.3g}, exact {res['exact_quantized']:.6f}"
                f", bit-equal {res['bit_equal']}, kernel "
                f"{res['kernel_ms']:.3f} ms, plain {res['plain_ms']:.1f} ms")
    scene = build_scene(1, device=dev)
    inputs = rk.regen_inputs(scene, cam, 320, 192, 6)
    kw = dict(samples=6, max_depth=8, emit_depth=True)
    seg_k = rk.regen_kernel(*inputs, **kw)
    seg_p = rk.regen_reference(*inputs, **kw)
    seg_agree = float((seg_k == seg_p).float().mean())
    record["prepass_segments_agree"] = seg_agree
    if seg_agree <= MIN_EXACT:
        raise AssertionError(f"prepass segments agree on {seg_agree}")
    head, _ = compare(1280, 768, 2, 25, None, "vmem", 3)
    record["compare_headline_shape"] = head

    def warp_counts(inputs, spp, bounces, rr):
        """The count mode: hit-test issues per warp, summed, against the
        lanes' mean segments and against the warp iterations that the
        kernel's per-sample segments give (rk.warp_iterations), and those
        segments' iterations under the nested loop that kernel 1 ran
        before it regenerated (each sample waits for its longest path)."""
        per = rk.sample_segments(*inputs, samples=spp, max_depth=bounces,
                                 rr_start=rr)
        seg, issues, *_ = rk.regen_counts(*inputs, samples=spp,
                                          max_depth=bounces, rr_start=rr)
        mean = float(seg.double().view(-1, 32).mean(1).sum())
        nested = float(rk.warp_iterations(per, "nested").sum())
        out = {"warp_issues": int(issues.long().sum()),
               "lane_mean_segments": mean,
               "issues_over_mean": float(issues.double().sum()) / mean,
               "nested_iterations": nested, "nested_over_mean": nested / mean}
        # the compact kernel's block schedules on the same segments
        for loop in ("compact", "pool"):
            out[f"{loop}_over_mean"] = float(
                rk.warp_iterations(per, loop).sum()) / mean
        if not (torch.equal(seg, per.sum(0))
                and torch.equal(issues.double(), rk.warp_iterations(per))):
            raise AssertionError(f"count mode against its segments: {out}")
        return out

    def fmt_counts(c):
        return (f"issues {c['warp_issues']} = {c['issues_over_mean']:.3f}x the "
                f"lanes' mean, equal to the per-sample count; the nested "
                f"loop's per-sample wait would be {c['nested_over_mean']:.3f}x")

    row1_counts = warp_counts(rk.regen_inputs(build_scene(1, device=dev), cam,
                                              1280, 768, 2), 2, 25, None)
    record["counts_row1"] = row1_counts
    say("3 compare", f"count mode at 1280x768x2spp/25b parity: "
        f"{fmt_counts(row1_counts)}")
    say("3 compare", f"prepass segments agree on {seg_agree:.6f}; "
        f"{head['shape']}: max|d| {head['max_abs_err']:.3g}, exact "
        f"{head['exact_quantized']:.6f}, kernel {head['kernel_ms']:.2f} ms, "
        f"plain {head['plain_ms']:.1f} ms")

    # -- 4 the main path at full width ----------------------------------------
    record["headline"] = {}
    headline_imgs = {}
    for rr in (None, 2):
        cfg = RenderConfig(scene_id=1, width=1280, height=768, samples=100,
                           bounces=25, rr_start=rr)
        renderer = make_renderer(cfg, dev)
        scene = build_scene(1, device=dev)
        reset_counts()
        with RenderTimer(dev) as warm:
            img = renderer(scene, cam)
        times = []
        for _ in range(3):
            with RenderTimer(dev) as t:
                img = renderer(scene, cam)
            times.append(t.ms)
        launched = read_counts("4 headline " + ("parity" if rr is None else
                                                f"rr{rr}"))["regen_render"]
        if launched < 4:
            raise AssertionError(f"{launched} kernel launches for 4 renders")
        arr = img.cpu().numpy()
        if not (arr.shape == (768, 1280, 3) and np.isfinite(arr).all()
                and arr.min() >= 0.0 and arr.max() <= 1.0):
            raise AssertionError(f"headline image bad: {arr.shape}, "
                                 f"[{arr.min()}, {arr.max()}]")
        # the difficulty order (which the renderer leaves out) against none,
        # in alternating pairs
        order = rk.difficulty_order(rk.measure_difficulty(
            scene, cam, 1280, 768, 8, 6), 8, 6)
        pairs = []
        for _ in range(SORT_PAIRS):
            with RenderTimer(dev) as ts:
                ordered = rk.render_kernel(scene, cam, 1280, 768, 100, 25,
                                           rr_start=rr, pixel_order=order)
            with RenderTimer(dev) as tu:
                renderer(scene, cam)
            pairs.append((ts.ms, tu.ms))
        if not torch.equal(ordered, img):
            raise AssertionError("the difficulty order changed the image")
        wins = sum(a < b for a, b in pairs)
        head_counts = {
            sort: warp_counts(rk.regen_inputs(scene, cam, 1280, 768, 100,
                                              pixel_order=po), 100, 25, rr)
            for sort, po in (("sorted", order), ("unsorted", None))}
        best = min(times)
        name = "parity" if rr is None else f"rr{rr}"
        if rr is None:
            f32_headline = img
        headline_imgs[name] = img
        record["headline"][name] = {
            "render_ms": times, "warmup_ms": warm.ms,
            "sorted_unsorted_pairs_ms": pairs, "sorted_wins": wins,
            "counts": head_counts,
            "mrays_per_s": 1280 * 768 * 100 / best / 1e3,
            "vs_reference": REFERENCE_HEADLINE_MS / best,
        }
        say("4 headline", f"{name}: render_ms {', '.join(f'{t:.2f}' for t in times)}"
            f" | {1280 * 768 * 100 / best / 1e3:.1f} Mrays/s | "
            f"{REFERENCE_HEADLINE_MS / best:.3f}x the reference's "
            f"{REFERENCE_HEADLINE_MS} ms | warm-up "
            f"{warm.ms:.2f} ms | sorted won {wins} of {SORT_PAIRS} pairs "
            f"(sorted {', '.join(f'{a:.2f}' for a, _ in pairs)}; unsorted "
            f"{', '.join(f'{b:.2f}' for _, b in pairs)}); image unchanged")
        for sort, c in head_counts.items():
            say("4 headline", f"{name} {sort}: count mode {fmt_counts(c)}")
    # -- 5 the CLI ------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        res = subprocess.run(
            [sys.executable, "-m", "raytracingincuda_torch.cli", "--scene_id",
             "1", "--width", "320", "--height", "192", "--samples", "10",
             "--bounces", "25"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600,
        )
        if res.returncode != 0:
            raise AssertionError(f"cli failed: {res.stderr[-2000:]}")
        line = res.stdout.strip().splitlines()[-1]
        if not re.fullmatch(r"\s*[0-9.]+,\s*[0-9.]+", line):
            raise AssertionError(f"cli printed {line!r}")
        name = RenderConfig(scene_id=1).output_filename()
        if not (Path(tmp) / name).is_file():
            raise AssertionError(f"cli wrote no {name}")
    record["cli_line"] = line
    say("5 cli", f"render_ms,e2e_ms = {line.strip()} ; wrote {name}")

    # -- 6 the gradient kernels against their plain versions ----------------
    record["grads"] = []
    scene = build_scene(1, device=dev)
    inputs = rk.regen_inputs(scene, cam, 320, 192, 4)
    ids = inputs[0]
    gen = torch.Generator().manual_seed(3)
    g_rows = (torch.randn((3, ids.shape[0]), generator=gen) * 1e-4).to(dev)
    grad_in = (*inputs[:3], g_rows, *inputs[4:])
    for rr in (None, 2):
        plain = None
        for layout in ("vmem", "hbm"):
            kw = dict(samples=4, max_depth=8, rr_start=rr, layout=layout)
            k_out, k_ms = timed(lambda: tk.grad_kernel(*grad_in, **kw), 3)
            again = tk.grad_kernel(*grad_in, **kw)
            if plain is None:
                plain = timed(lambda: tk.grad_reference(*grad_in, **kw), 1,
                              warm=False)
            res = {"kernel": "grad_render", "shape": "320x192x4spp/8b",
                   "rr_start": rr, "layout": layout, "kernel_ms": k_ms,
                   "plain_ms": plain[1], "run_to_run_identical": all(
                       torch.equal(a, b) for a, b in zip(k_out, again)),
                   **grad_compare(k_out, plain[0], ("d_scene", "d_cam"))}
            record["grads"].append(res)
            if not (res["run_to_run_identical"] and res["d_scene"]["ok"]
                    and res["d_cam"]["ok"]):
                raise AssertionError(f"gradient kernel vs plain failed: {res}")
            say("6 grads", f"A {res['shape']} rr={rr} {layout}: d_scene "
                f"max|d|/max {res['d_scene']['max_rel_to_largest']:.3g}, "
                f"d_cam {res['d_cam']['max_rel_to_largest']:.3g} (tol rtol "
                f"{GRAD_RTOL} + {GRAD_ATOL_FRAC} max); run-to-run identical;"
                f" kernel {k_ms:.3f} ms, plain {plain[1]:.1f} ms")

    def fused_compare(width, height, spp, bounces, loss, gamma, reps):
        scene = build_scene(1, device=dev)
        inputs = rk.regen_inputs(scene, cam, width, height, spp)
        gen = torch.Generator().manual_seed(4)
        tgt = torch.rand((3, inputs[0].shape[0]), generator=gen).to(dev)
        f_in = (*inputs[:3], tgt, *inputs[4:])
        kw = dict(samples=spp, max_depth=bounces, rr_start=2,
                  num_pixels=width * height, gamma=gamma, loss=loss,
                  huber_delta=0.25)
        k_out, k_ms = timed(lambda: tk.fused_train_kernel(*f_in, **kw), reps)
        again = tk.fused_train_kernel(*f_in, **kw)
        p_out, p_ms = timed(lambda: tk.fused_train_reference(*f_in, **kw), 1,
                            warm=False)
        img = rk.regen_kernel(*inputs, samples=spp, max_depth=bounces,
                              rr_start=2, finalize_scale=1.0 / spp if gamma
                              else None)
        if not gamma:
            img = img * tk.loss_constants(spp, width * height, 0.25)["inv_spp"]
        res = {"kernel": "fused_train_render",
               "shape": f"{width}x{height}x{spp}spp/{bounces}b", "loss": loss,
               "gamma": gamma, "kernel_ms": k_ms, "plain_ms": p_ms,
               "image_equals_regen": bool(torch.equal(k_out[1], img)),
               "image_equals_plain": bool(torch.equal(k_out[1], p_out[1])),
               "run_to_run_identical": all(torch.equal(a, b)
                                           for a, b in zip(k_out, again)),
               **grad_compare((k_out[0].reshape(1), k_out[2], k_out[3]),
                              (p_out[0].reshape(1), p_out[2], p_out[3]),
                              ("loss", "d_scene", "d_cam"))}
        record["grads"].append(res)
        if not (res["image_equals_regen"] and res["image_equals_plain"]
                and res["run_to_run_identical"] and res["loss"]["ok"]
                and res["d_scene"]["ok"] and res["d_cam"]["ok"]):
            raise AssertionError(f"fused kernel vs plain failed: {res}")
        say("6 grads", f"B {res['shape']} rr2 {loss} gamma={gamma}: image "
            f"bit-equal to regen and plain; loss rel "
            f"{res['loss']['max_rel_to_largest']:.3g}, d_scene "
            f"{res['d_scene']['max_rel_to_largest']:.3g}, d_cam "
            f"{res['d_cam']['max_rel_to_largest']:.3g}; run-to-run "
            f"identical; kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        return res

    for loss in tk.LOSSES:
        for gamma in (True, False):
            fused_compare(64, 40, 8, 6, loss, gamma, 3)
    fused_head = fused_compare(1280, 768, 2, 25, "mse", True, 3)

    def park_gates(width, height, spp, bounces, rr):
        """Kernel 2's outputs the same bits at any park capacity, window
        and accumulator route; kernel 3 on kernel 2's own g gives its
        gradients bit for bit."""
        inputs = rk.regen_inputs(build_scene(1, device=dev), cam, width,
                                 height, spp)
        gen = torch.Generator().manual_seed(8)
        tgt = torch.rand((3, inputs[0].shape[0]), generator=gen).to(dev)
        f_in = (*inputs[:3], tgt, *inputs[4:])
        kw = dict(samples=spp, max_depth=bounces, rr_start=rr,
                  num_pixels=width * height)
        parts = tk.fused_train_parts(*f_in, **kw)
        want = tk.fused_train_kernel(*f_in, **kw)
        lanes, n = inputs[0].shape[0], inputs[4].shape[0]
        block = (rk.PAD * 4 * spp * tk.PARK_ENTRIES_PER_SAMPLE
                 + 4 * n * kio.GRAD_COLS * 4)
        variants = {"capacity 0": dict(capacity=0),
                    f"capacity {spp}": dict(capacity=spp),
                    "2 windows": dict(budget=block * (lanes // rk.PAD + 1) // 2),
                    "5 windows": dict(budget=block * (lanes // rk.PAD + 4) // 5),
                    "shared accumulators": dict(acc="shared")}
        equal, windows = {}, {}
        for name, extra in variants.items():
            windows[name] = len(tk.plan_park(lanes, spp, bounces, n,
                                             **extra).windows)
            got = tk.fused_train_kernel(*f_in, **extra, **kw)
            equal[name] = all(torch.equal(a, b) for a, b in zip(got, want))
        small = tk.fused_train_parts(*f_in, capacity=spp, **kw).parked[0]
        overflowed = float((small < spp).double().mean())
        g_out = tk.grad_kernel(*inputs[:3], parts.g, *inputs[4:],
                               samples=spp, max_depth=bounces, rr_start=rr)
        res = {"shape": f"{width}x{height}x{spp}spp/{bounces}b",
               "rr_start": rr, "default_capacity": parts.plan.capacity,
               "bit_equal": equal, "windows": windows,
               "lanes_overflowed_at_capacity_spp": overflowed,
               "grad_kernel_on_fused_g_equal": bool(
                   torch.equal(g_out[0], want[2])
                   and torch.equal(g_out[1], want[3]))}
        record.setdefault("park_gates", []).append(res)
        if not (all(equal.values()) and res["grad_kernel_on_fused_g_equal"]
                and windows["2 windows"] == 2 and windows["5 windows"] == 5
                and 0.0 < overflowed < 1.0):
            raise AssertionError(f"park gates failed: {res}")
        say("6 grads", f"B {res['shape']} rr={rr}: outputs bit-equal at "
            f"capacity 0, {spp} ({100 * overflowed:.1f}% of lanes overflow) "
            f"and {parts.plan.capacity}, in 2 and 5 windows, with shared "
            f"accumulators; A on B's g equals B's gradients bit for bit")

    for rr in (None, 2):
        park_gates(1280, 768, 2, 25, rr)
    grad_main = next(r for r in record["grads"] if r["kernel"] == "grad_render"
                     and r["rr_start"] == 2 and r["layout"] == "vmem")

    # -- 7 the train step at full width -------------------------------------
    width, height, spp, bounces = 1280, 768, 100, 25
    scene = build_scene(1, device=dev)
    reset_counts()
    seg = rk.measure_difficulty(scene, cam, width, height, 8, 6)
    order = rk.difficulty_order(seg, 8, 6)
    gen = torch.Generator().manual_seed(0)
    target = torch.rand((height, width, 3), generator=gen).to(dev)
    step = tk.make_mse_train(scene.mat_type, scene.active, width, height, spp,
                             bounces, gamma=True, pixel_order=order, rr_start=2)
    with RenderTimer(dev) as warm:
        step(scene.params, cam, target)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        with RenderTimer(dev) as t:
            loss_v, img, (d_params, d_cam) = step(scene.params, cam, target)
        times.append(t.ms)
    train_launches = read_counts("7 train")
    train_peak = torch.cuda.max_memory_allocated() / 2**20
    # 4 steps, each a park render and a reverse in one window
    if (train_launches["fused_train_render"] < 8
            or train_launches["regen_render"] < 1):
        raise AssertionError(f"train headline launches {train_launches}")
    grads = param_leaves(d_params) + config_leaves(d_cam)
    finite = all(bool(torch.isfinite(x).all()) for x in grads)
    mse = float(((img.double() - target.double()) ** 2).mean())
    loss_f = float(loss_v)
    if not (finite and img.shape == (height, width, 3)
            and abs(loss_f - mse) <= 1e-6 * abs(mse)):
        raise AssertionError(f"train headline: finite {finite}, image "
                             f"{tuple(img.shape)}, loss {loss_f} vs MSE {mse}")
    best = min(times)
    rr2_best = min(record["headline"]["rr2"]["render_ms"])
    # the step's device time by kernel, in one profiler window
    idle = profiled_idle(lambda: step(scene.params, cam, target))
    split = {}
    for name, ms in idle["top_device_ms"].items():
        for part in ("park_render_kernel", "reverse_kernel",
                     "reduce_rows_kernel"):
            if part in name:
                split[part] = split.get(part, 0.0) + ms
    # the park at the step's inputs: entries a lane, samples re-traced
    ids, ii, jj, _, sm, row = rk.regen_inputs(scene, cam, width, height, spp,
                                              pixel_order=order)
    parts = tk.fused_train_parts(
        ids, ii, jj, kio.lane_rows(target, ids, width * height), sm, row,
        samples=spp, max_depth=bounces, rr_start=2,
        num_pixels=width * height)
    pk = parts.parked[:, :width * height].double()
    park = {"budget_mib": tk.PARK_BUDGET / 2**20,
            "capacity": parts.plan.capacity,
            "windows": len(parts.plan.windows),
            "acc_in_smem": parts.plan.acc_in_smem,
            "entries_per_lane_mean": float(pk[1].mean()),
            "entries_per_lane_max": float(pk[1].max()),
            "samples_retraced_share": float(
                1.0 - pk[0].sum() / (spp * width * height))}
    del parts, pk
    record["train"] = {
        "fused_train_step_ms": times, "warmup_ms": warm.ms,
        "loss": loss_f, "image_mse": mse, "vs_rr2_render": best / rr2_best,
        "launches": train_launches, "peak_mib": train_peak,
        "profile": idle, "device_ms_split": split, "park": park,
    }
    if not (split.get("park_render_kernel") and split.get("reverse_kernel")):
        raise AssertionError(f"train step's device time: {idle}")
    say("7 train", f"fused_train_step_ms {', '.join(f'{t:.2f}' for t in times)}"
        f" | {best / rr2_best:.3f}x the rr2 render ({rr2_best:.2f} ms) | "
        f"loss {loss_f:.6g} = image MSE {mse:.6g} | gradients finite | "
        f"warm-up {warm.ms:.2f} ms | peak {train_peak:.1f} MiB (park budget "
        f"{park['budget_mib']:.0f} MiB) | device ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f" (idle {fmt_idle(idle)}) | park: capacity {park['capacity']} in "
        f"{park['windows']} window(s), entries a lane mean "
        f"{park['entries_per_lane_mean']:.2f} max "
        f"{park['entries_per_lane_max']:.0f}, samples re-traced "
        f"{100 * park['samples_retraced_share']:.4f}%")

    # -- 8 the trainer --------------------------------------------------------
    from raytracingincuda_torch.examples import inverse_rendering
    from raytracingincuda_torch.models.scene import SceneParams
    from raytracingincuda_torch.ops import grad as gradlib
    from raytracingincuda_torch.ops.vec import Vec3

    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        args = inverse_rendering.build_parser().parse_args(
            ["--device", "cuda", "--impl", "fused", "--steps", "20",
             "--out", str(Path(tmp) / "recovered.ppm")])
        losses = inverse_rendering.run(args)
    scene2 = build_scene(2, pad_to_multiple=64, device=dev)
    init_fn, step_fn = gradlib.make_train_step(
        96, 58, 4, 6, learning_rate=2e-2, impl="kernel",
        trainable=SceneParams(Vec3(False, False, False), False,
                              Vec3(True, True, True), False, False))
    tgt2 = rk.render_kernel(scene2, cam, 96, 58, 4, 6, gamma=False)
    gray = torch.full_like(scene2.params.albedo.x, 0.5)
    start = scene2.params._replace(albedo=Vec3(gray, gray, gray))
    state, k_loss = step_fn(init_fn(start), cam, scene2.mat_type,
                            scene2.active, tgt2)
    trainer_launches = read_counts("8 trainer")
    record["trainer"] = {"losses": losses, "kernel_step_loss": float(k_loss),
                         "launches": trainer_launches}
    if not (losses[-1] < losses[0] and all(np.isfinite(losses))
            and trainer_launches["fused_train_render"] >= 40
            and trainer_launches["grad_render"] >= 1
            and float(k_loss) > 0.0 and np.isfinite(float(k_loss))
            and all(bool(torch.isfinite(x).all())
                    for x in state.params.albedo)):
        raise AssertionError(f"trainer failed: {record['trainer']}")
    say("8 trainer", f"example impl=fused 20 steps: loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; make_train_step(impl='kernel') step loss "
        f"{float(k_loss):.6f}; launches {trainer_launches}")

    # -- 9 the stream kernel against its plain version ---------------------
    from raytracingincuda_torch.models.camera import initialize
    from raytracingincuda_torch.models.scene import Scene, build_random_scene

    def lanes(width, height, spp):
        ids, ii, jj, bud = kio.lane_setup(width, height, None, spp, 0, None,
                                          dev)
        row = rk.pack_camera(initialize(cam, width, height)).to(dev)
        return ids, ii, jj, bud, row

    def walk_stats(st, width, height, spp, bounces, rr):
        """(traced segments, opened blocks, blocks the warps walked, rows
        the warps tested) of the walk at these inputs, from the kernel's
        own counts."""
        ids, ii, jj, bud, row = lanes(width, height, spp)
        c = sk.stream_kernel(ids, ii, jj, bud, st.scene_mat, st.bounds, row,
                             block=st.block, samples=spp, max_depth=bounces,
                             rr_start=rr, emit_stats=True).double().sum(1)
        return tuple(float(v) for v in c)

    def walk_ops(st, segs, opened, fetched, tested):
        """The walk's operations: every lane's bound test of every bounds
        row a segment and its box tests of the groups of every block it
        opens, and the warps' tested rows times the mean count of their
        lanes that opened those blocks (opened / walked), a sphere test
        each."""
        return ((segs * st.bounds.shape[0] + tested * opened / max(fetched, 1))
                * OPS_TEST_STAGED
                + opened * sk.block_groups(st.block) * OPS_BOX_TEST)

    def stream_compare(st, width, height, spp, bounces, rr, reps=5):
        ids, ii, jj, bud, row = lanes(width, height, spp)
        args = (ids, ii, jj, bud, st.scene_mat, st.bounds, row)
        kw = dict(block=st.block, samples=spp, max_depth=bounces,
                  rr_start=rr, finalize_scale=1.0 / spp)
        k_out, k_ms = timed(lambda: sk.stream_kernel(*args, **kw), reps)
        again = sk.stream_kernel(*args, **kw)
        p_out, p_ms = timed(lambda: sk.stream_reference(*args, **kw), 1,
                            warm=False)
        k_stats = sk.stream_kernel(*args, emit_stats=True, **kw)
        p_stats = sk.stream_reference(*args, emit_stats=True, **kw)
        segs, opened, fetched, tested = (float(v)
                                         for v in k_stats.double().sum(1))
        padded = ids.shape[0]
        res = {"shape": f"{width}x{height}x{spp}spp/{bounces}b",
               "rows": st.scene_mat.shape[0], "block": st.block,
               "blocks": st.bounds.shape[0], "rr_start": rr,
               "bit_equal": bool(torch.equal(k_out, p_out)),
               "run_to_run_identical": bool(torch.equal(k_out, again)),
               "max_abs_err": float((k_out - p_out).abs().max()),
               "stats_equal": bool(torch.equal(k_stats, p_stats)),
               "segments": segs, "opened_blocks": opened,
               "opened_per_segment": opened / max(segs, 1.0),
               "warp_tested_blocks": fetched,
               "lane_tests_over_opened": 32 * fetched / max(opened, 1.0),
               "rows_tested": tested,
               "rows_tested_share": tested / max(fetched * st.block, 1.0),
               "kernel_ms": k_ms, "plain_ms": p_ms}
        res["bound_ms"], res["bound_by"], res["bound_fmad_off_ms"] = bound(
            walk_ops(st, segs, opened, fetched, tested),
            padded * 28 + st.scene_mat.shape[0] * kio.USED_COLS * 4
            + st.bounds.numel() * 4 + 96)
        if not (res["bit_equal"] and res["run_to_run_identical"]
                and res["stats_equal"]):
            raise AssertionError(f"stream kernel vs plain failed: {res}")
        return res, k_out

    def share_equal(a, b) -> float:
        return float((ppm.quantize(a.cpu().numpy())
                      == ppm.quantize(b.cpu().numpy())).mean())

    record["stream_compare"] = []
    s10k = build_random_scene(10_000, seed=3, device=dev)
    morton = sk.prepare_stream_scene(s10k)
    front = sk.reorder_front_to_back(morton,
                                     initialize(cam, 64, 40).center)
    for rr in (None, 2):
        res, img_front = stream_compare(front, 64, 40, 2, 6, rr)
        record["stream_compare"].append(res)
        say("9 stream", f"10k spheres {res['shape']} rr={rr}: bit-equal to "
            f"plain, run-to-run identical, work counts equal ({res['segments']:.0f}"
            f" segments, {res['opened_per_segment']:.2f} of {res['blocks']} "
            f"blocks opened a segment); kernel {res['kernel_ms']:.3f} ms, plain "
            f"{res['plain_ms']:.1f} ms, bound {res['bound_ms']:.4f} ms")
        if rr is None:
            _, img_morton = stream_compare(morton, 64, 40, 2, 6, rr, reps=1)
            order_share = share_equal(img_front, img_morton)
    s1 = build_scene(1, device=dev)
    one = sk.prepare_stream_scene(s1, block=512, pad_pairs=False)
    res_one, _ = stream_compare(one, 64, 40, 2, 6, None)
    record["stream_compare"].append(res_one)
    s100k = build_random_scene(100_000, seed=3, device=dev)
    st100k = sk.reorder_front_to_back(sk.prepare_stream_scene(s100k),
                                      initialize(cam, 160, 96).center)
    img_s = sk.render_stream(st100k, cam, 160, 96, 2, 10)
    img_h = rk.render_kernel(s100k, cam, 160, 96, 2, 10, layout="hbm")
    hbm_share = share_equal(img_s, img_h)
    record["stream_order_share"] = order_share
    record["stream_vs_hbm_share_100k"] = hbm_share
    if not (order_share >= MIN_EXACT and hbm_share >= MIN_EXACT):
        raise AssertionError(f"stream shares: Morton vs front-to-back "
                             f"{order_share}, vs hbm at 100k {hbm_share}")
    say("9 stream", f"scene 1 as one block of 512: bit-equal to plain; "
        f"Morton vs front-to-back order equal on {order_share:.6f} of "
        f"components; 100k spheres 160x96x2spp/10b equal to the hbm regen "
        f"kernel on {hbm_share:.6f}")

    # -- 10 the stream render at full width --------------------------------
    w, h = 640, 384
    cfg = RenderConfig(scene_id=0, width=w, height=h, samples=10, bounces=10,
                       impl="stream")
    renderer = make_renderer(cfg, dev)
    renderer.prepare(s100k)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with RenderTimer(dev) as warm:
        img = renderer(s100k, cam)
    times = []
    for _ in range(3):
        with RenderTimer(dev) as t:
            img = renderer(s100k, cam)
        times.append(t.ms)
    head_counts = read_counts("10 stream headline")
    peak = torch.cuda.max_memory_allocated() / 2**20
    arr = img.cpu().numpy()
    if not (head_counts["stream_render"] >= 4 and arr.shape == (h, w, 3)
            and np.isfinite(arr).all()):
        raise AssertionError(f"stream headline: {head_counts}, {arr.shape}")
    stream_headline_img = img
    with RenderTimer(dev) as brute:
        rk.render_kernel(s100k, cam, w, h, 2, 10, layout="hbm")
    st_head = sk.reorder_front_to_back(sk.prepare_stream_scene(s100k),
                                       initialize(cam, w, h).center)
    segs, opened, fetched, tested = walk_stats(st_head, w, h, 10, 10, None)
    head_bound = bound(walk_ops(st_head, segs, opened, fetched, tested), 0)[0]
    segs2 = float(rk.regen_kernel(*rk.regen_inputs(s100k, cam, w, h, 2),
                                  samples=2, max_depth=10, emit_depth=True,
                                  layout="hbm").double().sum())
    brute_bound = bound(segs2 * s100k.num_slots * OPS_TEST, 0)[0]
    best = min(times)
    record["stream_headline"] = {
        "render_ms": times, "warmup_ms": warm.ms, "launches": head_counts,
        "brute_force_hbm_2spp_ms": brute.ms, "peak_mib": peak,
        "segments": segs, "opened_blocks": opened,
        "opened_per_segment": opened / segs, "warp_tested_blocks": fetched,
        "lane_tests_over_opened": 32 * fetched / opened,
        "rows_tested_share": tested / (fetched * st_head.block),
        "bound_ms": head_bound,
        "brute_force_2spp_bound_ms": brute_bound,
        "mrays_per_s": w * h * 10 / best / 1e3}
    say("10 stream headline", f"100k spheres {w}x{h}x10spp/10b: render_ms "
        f"{', '.join(f'{t:.2f}' for t in times)} (warm-up {warm.ms:.2f}); "
        f"{opened / segs:.2f} of {st_head.bounds.shape[0]} blocks opened a "
        f"segment, each lane tests {32 * fetched / opened:.3f}x the blocks "
        f"it opened (its warp's union), bound {head_bound:.3f} ms; "
        f"brute-force hbm at 2 spp "
        f"{brute.ms:.2f} ms (bound {brute_bound:.3f}); peak {peak:.1f} MiB;"
        f" launches {nonzero(head_counts)}")

    # -- 11 the stream train kernel against its plain versions --------------
    def spheres(st) -> int:
        return int(st.perm.shape[0])

    def stream_grads_compare(st, width, height, spp, bounces, rr, g_rows,
                             reps=3):
        """The gradient mode against its plain version on the same inputs."""
        ids, ii, jj, _, row = lanes(width, height, spp)
        args = (ids, ii, jj, g_rows, st.scene_mat, st.bounds, row)
        kw = dict(block=st.block, samples=spp, max_depth=bounces, rr_start=rr)
        k_out, k_ms = timed(lambda: stk.stream_grads_kernel(*args, **kw), reps)
        again = stk.stream_grads_kernel(*args, **kw)
        p_out, p_ms = timed(lambda: stk.stream_grads_reference(*args, **kw),
                            1, warm=False)
        res = {"kernel": "stream_train", "mode": "grads",
               "spheres": spheres(st), "block": st.block,
               "shape": f"{width}x{height}x{spp}spp/{bounces}b",
               "rr_start": rr, "kernel_ms": k_ms, "plain_ms": p_ms,
               "run_to_run_identical": all(
                   torch.equal(a, b) for a, b in zip(k_out, again)),
               **grad_compare(k_out, p_out, ("d_stream", "d_cam"))}
        record["stream_grads"].append(res)
        if not (res["run_to_run_identical"] and res["d_stream"]["ok"]
                and res["d_cam"]["ok"]):
            raise AssertionError(f"stream gradients vs plain failed: {res}")
        say(phase, f"grads {res['spheres']} spheres block {st.block} "
            f"{res['shape']} rr={rr}: d_stream max|d|/max "
            f"{res['d_stream']['max_rel_to_largest']:.3g}, d_cam "
            f"{res['d_cam']['max_rel_to_largest']:.3g}; run-to-run "
            f"identical; kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        return res

    def stream_fused_compare(st, width, height, spp, bounces, rr, tgt_rows,
                             loss, gamma, reps=3):
        """The fused mode against its plain version on the same inputs; its
        image bit-equal to the stream kernel's and the plain version's."""
        ids, ii, jj, bud, row = lanes(width, height, spp)
        args = (ids, ii, jj, tgt_rows, st.scene_mat, st.bounds, row)
        kw = dict(block=st.block, samples=spp, max_depth=bounces,
                  rr_start=rr, num_pixels=width * height, gamma=gamma,
                  loss=loss, huber_delta=0.25)
        k_out, k_ms = timed(lambda: stk.fused_stream_kernel(*args, **kw),
                            reps)
        again = stk.fused_stream_kernel(*args, **kw)
        p_out, p_ms = timed(lambda: stk.fused_stream_reference(*args, **kw),
                            1, warm=False)
        img4 = sk.stream_kernel(ids, ii, jj, bud, st.scene_mat, st.bounds,
                                row, block=st.block, samples=spp,
                                max_depth=bounces, rr_start=rr,
                                finalize_scale=1.0 / spp if gamma else None)
        if not gamma:
            img4 = img4 * tk.loss_constants(spp, width * height,
                                            0.25)["inv_spp"]
        res = {"kernel": "stream_train", "mode": "fused",
               "spheres": spheres(st), "block": st.block,
               "shape": f"{width}x{height}x{spp}spp/{bounces}b",
               "rr_start": rr, "loss": loss, "gamma": gamma,
               "kernel_ms": k_ms, "plain_ms": p_ms,
               "image_equals_stream_render": bool(torch.equal(k_out[1], img4)),
               "image_equals_plain": bool(torch.equal(k_out[1], p_out[1])),
               "run_to_run_identical": all(torch.equal(a, b)
                                           for a, b in zip(k_out, again)),
               **grad_compare((k_out[0].reshape(1), k_out[2], k_out[3]),
                              (p_out[0].reshape(1), p_out[2], p_out[3]),
                              ("loss", "d_stream", "d_cam"))}
        record["stream_grads"].append(res)
        if not (res["image_equals_stream_render"] and res["image_equals_plain"]
                and res["run_to_run_identical"] and res["loss"]["ok"]
                and res["d_stream"]["ok"] and res["d_cam"]["ok"]):
            raise AssertionError(f"fused stream kernel vs plain failed: {res}")
        say(phase, f"fused {res['spheres']} spheres block {st.block} "
            f"{res['shape']} rr={rr} {loss} gamma={gamma}: image bit-equal "
            f"to the stream kernel's and the plain version's; loss rel "
            f"{res['loss']['max_rel_to_largest']:.3g}, d_stream "
            f"{res['d_stream']['max_rel_to_largest']:.3g}, d_cam "
            f"{res['d_cam']['max_rel_to_largest']:.3g}; run-to-run "
            f"identical; kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        return res

    def stream_train_bound(st, width, height, spp, bounces, rr):
        """The fused step's bound: one walk per sample, its inputs read and
        its outputs written once."""
        segs, opened, fetched, tested = walk_stats(st, width, height, spp,
                                                   bounces, rr)
        padded = lanes(width, height, spp)[0].shape[0]
        return bound(walk_ops(st, segs, opened, fetched, tested),
                     padded * 36 + st.scene_mat.shape[0]
                     * (kio.USED_COLS + 16) * 4 + st.bounds.numel() * 4 + 192)

    phase = "11 stream grads"
    s1k = build_random_scene(1000, seed=3, device=dev)
    st1k = sk.prepare_stream_scene(s1k, block=64)
    ids = lanes(64, 40, 4)[0]
    gen = torch.Generator().manual_seed(3)
    g_rows = (torch.randn((3, ids.shape[0]), generator=gen) * 1e-3).to(dev)
    record["stream_grads"] = []
    for rr in (None, 2):
        stream_grads_compare(st1k, 64, 40, 4, 6, rr, g_rows)
    tgt_rows = torch.rand((3, ids.shape[0]), generator=gen).to(dev)
    for loss in tk.LOSSES:
        for gamma in (False, True):
            stream_fused_compare(st1k, 64, 40, 4, 6, 2, tgt_rows, loss, gamma)

    # -- 12 the stream train step at full width -----------------------------
    from raytracingincuda_torch.ops import grad as gradlib
    from raytracingincuda_torch.ops.rng import DEFAULT_SEED
    from raytracingincuda_torch.ops.stream_kernel import StreamScene

    spp, bounces = 4, 10
    gen = torch.Generator().manual_seed(5)
    target = torch.rand((h, w, 3), generator=gen).to(dev)
    stream = sk.prepare_stream_scene(s100k)
    init_fn, step_fn = gradlib.make_stream_train(stream, w, h, spp, bounces)
    state0 = init_fn(s100k.params)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with RenderTimer(dev) as warm:
        state, loss0 = step_fn(state0, cam, s100k.mat_type, s100k.active,
                               target)
    times = []
    for _ in range(3):
        with RenderTimer(dev) as t:
            state, loss_v = step_fn(state, cam, s100k.mat_type,
                                    s100k.active, target)
        times.append(t.ms)
    step_counts = read_counts("12 stream train (fused)")
    peak = torch.cuda.max_memory_allocated() / 2**20
    # the step's first loss against the image of the same parameters
    border = gradlib.front_to_back_border(stream, cam, w, h)
    st0 = StreamScene(*sk.build_stream_arrays(
        Scene(state0.params, s100k.mat_type, s100k.active), stream.perm,
        stream.block, stream.scene_mat.shape[0], border=border),
        stream.block, stream.perm)
    img0 = sk.render_stream(st0, cam, w, h, spp, bounces, gamma=False)
    mse = float(((img0.double() - target.double()) ** 2).mean())
    chk_loss, d_stream, d_cam = stk.mse_train_stream(st0, cam, target, w, h,
                                                     spp, bounces)
    finite = (bool(torch.isfinite(d_stream).all())
              and bool(torch.isfinite(d_cam).all())
              and all(bool(torch.isfinite(x).all())
                      for x in param_leaves(state.params)))
    if not (finite and step_counts["stream_train"] >= 4
            and step_counts["stream_segment_sum"] >= 4
            and float(chk_loss) == float(loss0)
            and abs(float(loss0) - mse) <= 1e-6 * abs(mse)):
        raise AssertionError(f"stream train step: finite {finite}, launches "
                             f"{step_counts}, loss {float(loss0)} vs "
                             f"{float(chk_loss)} vs image MSE {mse}")
    init2, step2 = gradlib.make_stream_train(stream, w, h, spp, bounces,
                                             fused=False)
    reset_counts()
    with RenderTimer(dev) as two:
        _, loss_two = step2(state0, cam, s100k.mat_type, s100k.active,
                            target)
    two_counts = read_counts("12 stream train (fused=False)")
    two_rel = abs(float(loss_two) - float(loss0)) / float(loss0)
    if two_rel > GRAD_RTOL or two_counts["stream_render"] < 1:
        raise AssertionError(f"two-program step loss {float(loss_two)} vs "
                             f"{float(loss0)}, launches {two_counts}")
    # one more fused step in a profiler window: device time over wall time
    idle = profiled_idle(lambda: step_fn(state, cam, s100k.mat_type,
                                         s100k.active, target))
    segs, opened, k4_fetched, k4_rows = walk_stats(st0, w, h, spp, bounces,
                                                   None)
    step_bound = bound(walk_ops(st0, segs, opened, k4_fetched, k4_rows), 0)[0]
    # the warp union of the step's walk: blocks walked per warp against the
    # blocks each lane opened (kernel 4's count), and the rows it tested
    ids, ii, jj, _, row = lanes(w, h, spp)
    lane_open, warp_tested, warp_rows = stk.walk_counts(
        ids, ii, jj, st0.scene_mat, st0.bounds, row, block=st0.block,
        samples=spp, max_depth=bounces)
    union = {"opened_per_lane": int(lane_open.long().sum()),
             "tested_per_warp": int(warp_tested.long().sum()),
             "rows_tested_share": float(warp_rows.double().sum())
             / max(float(warp_tested.double().sum()) * st0.block, 1.0),
             "stream_kernel_rows_tested_share": k4_rows / max(
                 k4_fetched * st0.block, 1.0)}
    union["lane_tests_over_opened"] = (32 * union["tested_per_warp"]
                                       / max(union["opened_per_lane"], 1))
    union["stream_kernel_tested_per_warp"] = int(k4_fetched)
    union["stream_kernel_lane_tests_over_opened"] = 32 * k4_fetched / opened
    if union["opened_per_lane"] != int(opened):
        raise AssertionError(f"kernel 5's walk opened {union} blocks, the "
                             f"stream kernel's {opened}")
    # the scatter's kernels on this step's records
    rows = kio.lane_rows(target, ids, w * h)
    _, rec_row, rec_val, _, _ = stk.train_records(
        ids, ii, jj, rows, st0.scene_mat, st0.bounds, row, block=st0.block,
        samples=spp, max_depth=bounces, seed=DEFAULT_SEED, rr_start=None,
        sample_offset=0, fused=True, num_pixels=w * h)
    # every record sorted, the unwritten ones summed into one row past the
    # last (record_order); the plain version and index_add_ sum the same
    n_rows = st0.scene_mat.shape[0]
    (keys, src), order_ms = timed(lambda: stk.record_order(rec_row, n_rows),
                                  5)
    seg_out, seg_ms = timed(lambda: stk.segment_sum_kernel(keys, src, rec_val,
                                                           n_rows + 1), 5)
    seg_plain, seg_plain_ms = timed(lambda: stk.segment_sum_reference(
        keys, src, rec_val, n_rows + 1), 1, warm=False)
    seg_out, seg_plain = seg_out[:n_rows], seg_plain[:n_rows]
    lib_keys, lib_vals = keys.long(), rec_val[src]
    lib_out = torch.zeros((n_rows + 1, kio.GRAD_COLS), device=dev)
    _, lib_ms = timed(lambda: lib_out.zero_().index_add_(0, lib_keys,
                                                         lib_vals), 5)
    m = keys.shape[0]
    seg_bound, seg_by, seg_fmad_off = bound(m * kio.GRAD_COLS,
                                            m * 48 + n_rows * 36)
    segment_main = {"records": m, "kernel_ms": seg_ms,
                    "record_order_ms": order_ms,
                    "plain_ms": seg_plain_ms, "library_ms": lib_ms,
                    "bound_ms": seg_bound, "bound_by": seg_by,
                    "bound_fmad_off_ms": seg_fmad_off,
                    "bit_equal": bool(torch.equal(seg_out, seg_plain)),
                    "max_abs_err": float((seg_out - seg_plain).abs().max())}
    if not segment_main["bit_equal"]:
        raise AssertionError(f"segment sum vs plain: {segment_main}")
    # kernels 4 and 5 against their plain versions on this step's stream
    # (100k spheres, blocks of 256 front to back) at its width, with the
    # samples and depth cut for the plain versions' time
    phase = "12 stream train"
    cspp, cb = 1, 3
    tables_100k = record["walk_tables_100k"] = walk_tables(st0)
    say(phase, f"the walk's tables on the step's stream ({tables_100k['rows']}"
        f" rows, {tables_100k['groups']} groups): the card's group table "
        f"equals the twin word for word | kernel "
        f"{tables_100k['kernel_ms'] * 1e3:.2f} us "
        f"({tables_100k['kernel_ms_from']}), plain "
        f"{tables_100k['plain_ms']:.1f} ms, bound "
        f"{tables_100k['bound'][0] * 1e3:.2f} us")
    render_100k, _ = stream_compare(st0, w, h, cspp, cb, None, reps=3)
    record["stream_compare"].append(render_100k)
    say(phase, f"stream kernel 100k spheres block {st0.block} "
        f"{render_100k['shape']}: bit-equal to plain, run-to-run identical, "
        f"work counts equal ({render_100k['opened_per_segment']:.2f} of "
        f"{render_100k['blocks']} blocks opened a segment); kernel "
        f"{render_100k['kernel_ms']:.3f} ms, plain "
        f"{render_100k['plain_ms']:.1f} ms, bound "
        f"{render_100k['bound_ms']:.4f} ms")
    ids = lanes(w, h, cspp)[0]
    gen = torch.Generator().manual_seed(6)
    stream_grads_compare(st0, w, h, cspp, cb, None, (torch.randn(
        (3, ids.shape[0]), generator=gen) * 1e-3).to(dev))
    train_100k = stream_fused_compare(st0, w, h, cspp, cb, None,
                                      kio.lane_rows(target, ids, w * h),
                                      "mse", False)
    (train_100k["bound_ms"], train_100k["bound_by"],
     train_100k["bound_fmad_off_ms"]) = stream_train_bound(st0, w, h, cspp, cb,
                                                           None)
    best = min(times)
    record["stream_train"] = {
        "fused_step_ms": times, "warmup_ms": warm.ms, "launches": step_counts,
        "loss": float(loss0), "image_mse": mse, "peak_mib": peak,
        "two_program_step_ms": two.ms, "two_program_loss_rel": two_rel,
        "two_program_launches": two_counts, "segments": segs,
        "opened_blocks": opened, "bound_ms": step_bound,
        "idle_share": idle, "warp_union": union,
        "segment_sum": segment_main,
        "vs_stream_render": best / min(record["stream_headline"]["render_ms"])}
    say(phase, f"make_stream_train 100k spheres {w}x{h}x{spp}spp/"
        f"{bounces}b mse: fused_step_ms {', '.join(f'{t:.2f}' for t in times)}"
        f" (warm-up {warm.ms:.2f}); walk bound {step_bound:.3f} ms; loss "
        f"{float(loss0):.6g} = image MSE {mse:.6g}; gradients finite; peak "
        f"{peak:.1f} MiB; idle share {fmt_idle(idle)}; fused=False step "
        f"{two.ms:.2f} ms, loss rel {two_rel:.2g}; record_order "
        f"{order_ms:.3f} ms; segment sum of {m} records {seg_ms:.4f} ms "
        f"(plain {seg_plain_ms:.1f}, index_add_ {lib_ms:.4f}, bound "
        f"{seg_bound:.4f}), bit-equal to plain; warp union: "
        f"{union['tested_per_warp']} blocks tested by warps, "
        f"{union['opened_per_lane']} opened by lanes (= the stream "
        f"kernel's), each lane tests "
        f"{union['lane_tests_over_opened']:.3f}x the blocks it opened (the "
        f"stream kernel's regenerating warps at the same shape: "
        f"{union['stream_kernel_tested_per_warp']} blocks tested, "
        f"{union['stream_kernel_lane_tests_over_opened']:.3f}x); "
        f"launches fused {nonzero(step_counts)}, fused=False "
        f"{nonzero(two_counts)}")

    # -- 13 the 1M-sphere scale check ---------------------------------------
    del s10k, st100k, stream, st0, rec_row, rec_val, keys, src, lib_vals
    phase = "13 stream scale"
    s1m = build_random_scene(1_000_000, seed=3, half_extent=60.0, device=dev)
    t0 = time.perf_counter()
    st1m = sk.prepare_stream_scene(s1m)
    prep_s = time.perf_counter() - t0
    cfg = RenderConfig(scene_id=0, width=w, height=h, samples=1, bounces=10,
                       impl="stream")
    renderer = make_renderer(cfg, dev)
    renderer.prepare(s1m)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with RenderTimer(dev) as fwd:
        img = renderer(s1m, cam)
    fwd_counts = read_counts("13 stream scale (forward)")
    fwd_peak = torch.cuda.max_memory_allocated() / 2**20
    init_fn, step_fn = gradlib.make_stream_train(st1m, w, h, 1, 6)
    state0 = init_fn(s1m.params)
    tgt1m = torch.rand((h, w, 3), generator=gen).to(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with RenderTimer(dev) as step1m:
        state, loss1m = step_fn(state0, cam, s1m.mat_type, s1m.active, tgt1m)
    step1m_counts = read_counts("13 stream scale (step)")
    step_peak = torch.cuda.max_memory_allocated() / 2**20
    _, d_stream, d_cam = stk.mse_train_stream(
        StreamScene(*sk.build_stream_arrays(
            s1m, st1m.perm, st1m.block, st1m.scene_mat.shape[0],
            border=gradlib.front_to_back_border(st1m, cam, w, h)),
            st1m.block, st1m.perm), cam, tgt1m, w, h, 1, 6)
    finite = (bool(torch.isfinite(d_stream).all())
              and bool(torch.isfinite(d_cam).all())
              and bool(np.isfinite(img.cpu().numpy()).all())
              and all(bool(torch.isfinite(x).all())
                      for x in param_leaves(state.params)))
    # blocks of 1024 against the plain walk, front to back, few pixels
    st1m_front = sk.reorder_front_to_back(st1m, initialize(cam, w, h).center)
    tables_1m = record["walk_tables_1m"] = walk_tables(st1m)
    say(phase, f"the walk's tables at 1M ({tables_1m['groups']} groups of "
        f"blocks of {tables_1m['block']}): equal to the twin word for word; "
        f"kernel {tables_1m['kernel_ms'] * 1e3:.2f} us")
    render_1m, _ = stream_compare(st1m_front, 64, 40, 1, 6, None, reps=3)
    record["stream_compare"].append(render_1m)
    say(phase, f"stream kernel 1M spheres block {st1m.block} "
        f"{render_1m['shape']}: bit-equal to plain, run-to-run identical, "
        f"work counts equal; kernel {render_1m['kernel_ms']:.3f} ms, plain "
        f"{render_1m['plain_ms']:.1f} ms")
    ids = lanes(64, 40, 1)[0]
    stream_fused_compare(st1m_front, 64, 40, 1, 6, None, torch.rand(
        (3, ids.shape[0]), generator=gen).to(dev), "mse", False)
    record["stream_scale"] = {
        "block": st1m.block, "blocks": st1m.n_blocks, "prepare_s": prep_s,
        "forward_ms": fwd.ms, "forward_peak_mib": fwd_peak,
        "forward_launches": fwd_counts, "fused_step_ms": step1m.ms,
        "fused_step_peak_mib": step_peak, "step_launches": step1m_counts,
        "loss": float(loss1m)}
    if not (finite and st1m.block == 1024 and fwd_counts["stream_render"] >= 1
            and step1m_counts["stream_train"] >= 1):
        raise AssertionError(f"1M scale check: finite {finite}, "
                             f"{record['stream_scale']}")
    say(phase, f"1M spheres: block {st1m.block}, {st1m.n_blocks} "
        f"blocks (prepare {prep_s:.2f} s); forward {w}x{h}x1spp/10b "
        f"{fwd.ms:.2f} ms (peak {fwd_peak:.1f} MiB); fused step 1spp/6b "
        f"{step1m.ms:.2f} ms (peak {step_peak:.1f} MiB); gradients finite; "
        f"launches forward {nonzero(fwd_counts)}, step "
        f"{nonzero(step1m_counts)}")
    del s1m, st1m, st1m_front, state0, state, d_stream

    # -- 14 the stream CLI and the example ----------------------------------
    want = rk.render_kernel(build_scene(1, device=dev), cam, 320, 192, 10, 25)
    cli_shares = {}
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        for flags, cfg in (
                (["--impl", "stream"], RenderConfig(scene_id=1,
                                                    impl="stream")),
                (["--layout", "packed"], RenderConfig(scene_id=1,
                                                      layout="packed"))):
            res = subprocess.run(
                [sys.executable, "-m", "raytracingincuda_torch.cli",
                 "--scene_id", "1", "--width", "320", "--height", "192",
                 "--samples", "10", *flags],
                cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"cli {flags} failed: "
                                     f"{res.stderr[-2000:]}")
            line = res.stdout.strip().splitlines()[-1]
            name = cfg.output_filename()
            got, _ = ppm.read_ppm(str(Path(tmp) / name))
            cli_shares[name] = float((got == ppm.quantize(
                want.cpu().numpy())).mean())
            if not (re.fullmatch(r"\s*[0-9.]+,\s*[0-9.]+", line)
                    and cli_shares[name] >= MIN_EXACT):
                raise AssertionError(f"cli {flags}: {line!r}, {cli_shares}")
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        args = inverse_rendering.build_parser().parse_args(
            ["--device", "cuda", "--impl", "stream", "--n_spheres", "2000",
             "--steps", "20", "--out", str(Path(tmp) / "recovered.ppm")])
        stream_losses = inverse_rendering.run(args)
    example_counts = read_counts("14 stream example")
    record["stream_cli"] = cli_shares
    record["stream_trainer"] = {"losses": stream_losses,
                                "launches": example_counts}
    if not (stream_losses[-1] < stream_losses[0]
            and all(np.isfinite(stream_losses))
            and example_counts["stream_train"] >= 20):
        raise AssertionError(f"stream example: {record['stream_trainer']}")
    say("14 stream cli", f"--impl stream and --layout packed at scene 1 "
        f"320x192x10spp: {', '.join(f'{k} equal to the regen kernel on {v:.6f}' for k, v in cli_shares.items())}; "
        f"example --impl stream --n_spheres 2000, 20 steps: loss "
        f"{stream_losses[0]:.6g} -> {stream_losses[-1]:.6g}")

    # -- 15 the f64 kernel against its plain version -------------------------
    def bit_compare(kernel, plain, reps, plain_out=None):
        """A kernel and its plain version on the same inputs: bit for bit
        and from run to run, with both times."""
        k_out, k_ms = timed(kernel, reps)
        again = kernel()
        if plain_out is None:
            plain_out = timed(plain, 1, warm=False)
        p_out, p_ms = plain_out
        res = {"bit_equal": bool(torch.equal(k_out, p_out)),
               "run_to_run_identical": bool(torch.equal(k_out, again)),
               "max_abs_err": float((k_out - p_out).abs().max()),
               "kernel_ms": k_ms, "plain_ms": p_ms}
        if not (bool(torch.isfinite(k_out).all()) and res["bit_equal"]
                and res["run_to_run_identical"]):
            raise AssertionError(f"kernel vs plain failed: {res}")
        return res, k_out, plain_out

    def f64_compare(width, height, spp, bounces, layout, reps, plain=None,
                    sample_offset=0):
        inputs = fk.f64_inputs(build_scene(1, device=dev), cam, width, height)
        kw = dict(samples=spp, max_depth=bounces, layout=layout,
                  sample_offset=sample_offset)
        res, out, plain = bit_compare(lambda: fk.f64_kernel(*inputs, **kw),
                                      lambda: fk.f64_reference(*inputs, **kw),
                                      reps, plain)
        res.update(shape=f"{width}x{height}x{spp}spp/{bounces}b",
                   layout=layout, sample_offset=sample_offset)
        if sample_offset:
            # the window is not the one at 0: the draws moved
            res["differs_from_offset_0"] = not bool(torch.equal(
                out, fk.f64_kernel(*inputs, **dict(kw, sample_offset=0))))
            if not res["differs_from_offset_0"]:
                raise AssertionError(f"f64 kernel at an offset: {res}")
        record["f64_compare"].append(res)
        say("15 f64 compare", f"{res['shape']} {layout} sample_offset "
            f"{sample_offset}: bit-equal to plain, run-to-run identical; "
            f"kernel {res['kernel_ms']:.3f} ms, plain {res['plain_ms']:.1f} "
            f"ms")
        return res, plain

    record["f64_compare"] = []
    plain = None
    for layout in ("vmem", "hbm"):
        _, plain = f64_compare(320, 192, 4, 8, layout, 5, plain)
    f64_head, _ = f64_compare(1280, 768, 2, 25, "vmem", 3)
    # a window of samples at an offset (render_incremental's rounds)
    for layout in ("vmem", "hbm"):
        f64_compare(64, 40, 4, 8, layout, 5, sample_offset=5)
    del plain

    # -- 16 the f64 render at full width -------------------------------------
    cfg = RenderConfig(scene_id=1, width=1280, height=768, samples=100,
                       bounces=25, dtype="float64")
    renderer = make_renderer(cfg, dev)
    scene = build_scene(1, device=dev)
    reset_counts()
    with RenderTimer(dev) as warm:
        img64 = renderer(scene, cam)
    times = []
    for _ in range(3):
        with RenderTimer(dev) as t:
            img64 = renderer(scene, cam)
        times.append(t.ms)
    f64_counts = read_counts("16 f64 headline")
    arr = img64.cpu().numpy()
    if not (f64_counts["f64_render"] >= 4 and f64_counts["regen_render"] == 0
            and img64.dtype == torch.float64 and arr.shape == (768, 1280, 3)
            and np.isfinite(arr).all() and arr.min() >= 0.0
            and arr.max() <= 1.0):
        raise AssertionError(f"f64 headline: {f64_counts}, {img64.dtype}, "
                             f"{arr.shape}, [{arr.min()}, {arr.max()}]")
    levels = np.abs(ppm.quantize(arr) - ppm.quantize(
        f32_headline.cpu().numpy()))
    best = min(times)
    record["f64_headline"] = {
        "render_ms": times, "warmup_ms": warm.ms,
        "launches": f64_counts,
        "vs_f32_parity": best / min(record["headline"]["parity"]["render_ms"]),
        "vs_reference_f64": REFERENCE_F64_HEADLINE_MS / best,
        "gap_to_f32_mean_levels": float(levels.mean()),
        "gap_to_f32_share_ge1": float((levels >= 1).mean()),
        "gap_to_f32_max_levels": int(levels.max())}
    del img64
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        res = subprocess.run(
            [sys.executable, "-m", "raytracingincuda_torch.cli", "--scene_id",
             "1", "--width", "320", "--height", "192", "--samples", "10",
             "--dtype", "float64"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"cli --dtype float64 failed: "
                                 f"{res.stderr[-2000:]}")
        line = res.stdout.strip().splitlines()[-1]
        name = RenderConfig(scene_id=1, dtype="float64").output_filename()
        got, _ = ppm.read_ppm(str(Path(tmp) / name))
    want = make_renderer(RenderConfig(scene_id=1, dtype="float64"), dev)(
        scene, cam)
    if not (re.fullmatch(r"\s*[0-9.]+,\s*[0-9.]+", line)
            and np.array_equal(got, ppm.quantize(want.cpu().numpy()))):
        raise AssertionError(f"cli --dtype float64: {line!r}, {name}")
    record["f64_cli_line"] = line
    h64 = record["f64_headline"]
    say("16 f64 headline", f"render_ms {', '.join(f'{t:.2f}' for t in times)}"
        f" | {h64['vs_f32_parity']:.3f}x the f32 parity render | "
        f"{h64['vs_reference_f64']:.2f}x the reference's double "
        f"{REFERENCE_F64_HEADLINE_MS} ms | gap to the f32 image: mean "
        f"{h64['gap_to_f32_mean_levels']:.4f} levels, "
        f"{100 * h64['gap_to_f32_share_ge1']:.3f}% of components >= 1 level,"
        f" max {h64['gap_to_f32_max_levels']} | warm-up {warm.ms:.2f} ms | "
        f"launches {nonzero(f64_counts)} | cli --dtype float64 {line.strip()}"
        f", wrote {name}")

    # -- 17 the compact kernel ---------------------------------------------
    def compact_compare(width, height, spp, bounces, layout, reps,
                        plain=None):
        ids, ii, jj, bud, sm, row = rk.regen_inputs(
            build_scene(1, device=dev), cam, width, height, spp)
        kw = dict(samples=spp, max_depth=bounces, layout=layout,
                  finalize_scale=1.0 / spp)
        res, k_out, plain = bit_compare(
            lambda: ck.compact_kernel(ids, ii, jj, sm, row, **kw),
            lambda: ck.compact_reference(ids, ii, jj, sm, row, **kw), reps,
            plain)
        res.update(shape=f"{width}x{height}x{spp}spp/{bounces}b",
                   layout=layout, equals_regen_kernel=bool(torch.equal(
                       k_out, rk.regen_kernel(ids, ii, jj, bud, sm, row,
                                              **kw))))
        record["compact_compare"].append(res)
        if not res["equals_regen_kernel"]:
            raise AssertionError(f"compact kernel vs regen kernel: {res}")
        say("17 compact", f"{res['shape']} {layout}: bit-equal to plain and "
            f"to the regen kernel, run-to-run identical; kernel "
            f"{res['kernel_ms']:.3f} ms, plain {res['plain_ms']:.1f} ms")
        return res, plain

    record["compact_compare"] = []
    plain = None
    for layout in ("vmem", "hbm"):
        _, plain = compact_compare(320, 192, 10, 25, layout, 5, plain)
    compact_head, _ = compact_compare(1280, 768, 2, 25, "vmem", 3)
    del plain
    legacy = rk.render_kernel(scene, cam, 320, 192, 10, 25, legacy_sky=True)
    if not torch.equal(rk.render_kernel(scene, cam, 320, 192, 10, 25,
                                        mode="simple", legacy_sky=True),
                       legacy):
        raise AssertionError("mode='simple' legacy_sky differs from regen")
    reset_counts()
    with RenderTimer(dev) as warm:
        img_c = rk.render_kernel(scene, cam, 1280, 768, 100, 25,
                                 mode="compact")
    times = []
    for _ in range(3):
        with RenderTimer(dev) as t:
            img_c = rk.render_kernel(scene, cam, 1280, 768, 100, 25,
                                     mode="compact")
        times.append(t.ms)
    compact_counts = read_counts("17 compact headline")
    regen_times = []
    for _ in range(3):
        with RenderTimer(dev) as t:
            img_r = rk.render_kernel(scene, cam, 1280, 768, 100, 25)
        regen_times.append(t.ms)
    reset_counts()
    img_s = rk.render_kernel(scene, cam, 1280, 768, 100, 25, mode="simple")
    simple_counts = read_counts("17 simple headline")
    if not (compact_counts["compact_render"] >= 4
            and simple_counts["regen_render"] >= 1
            and torch.equal(img_c, img_r) and torch.equal(img_s, img_r)):
        raise AssertionError(f"compact headline: launches {compact_counts}, "
                             f"simple {simple_counts}, images equal "
                             f"{torch.equal(img_c, img_r)}, "
                             f"{torch.equal(img_s, img_r)}")
    # warp scans over the lanes' mean segments at this shape (phase 4's
    # count): kernel 1's warps, the refilling pool's blocks
    scans = record["headline"]["parity"]["counts"]["unsorted"]
    record["compact_headline"] = {
        "render_ms": times, "warmup_ms": warm.ms, "launches": compact_counts,
        "regen_unsorted_ms": regen_times, "simple_launches": simple_counts,
        "vs_regen_unsorted": min(times) / min(regen_times),
        "pool_scans_over_mean": scans["pool_over_mean"],
        "regen_scans_over_mean": scans["issues_over_mean"],
        "pool_scans_vs_regen": scans["pool_over_mean"]
        / scans["issues_over_mean"]}
    say("17 compact", f"headline render_kernel(mode='compact') render_ms "
        f"{', '.join(f'{t:.2f}' for t in times)} (warm-up {warm.ms:.2f}) "
        f"beside the regen kernel unsorted "
        f"{', '.join(f'{t:.2f}' for t in regen_times)}: "
        f"{min(times) / min(regen_times):.3f}x in time; warp scans "
        f"{scans['pool_over_mean']:.3f}x the lanes' mean against kernel 1's "
        f"{scans['issues_over_mean']:.3f}x "
        f"({record['compact_headline']['pool_scans_vs_regen']:.3f}x); "
        f"images bit-equal, and mode='simple' too; launches compact "
        f"{nonzero(compact_counts)}, simple {nonzero(simple_counts)}")
    del img_c, img_r, img_s

    # -- 18 adaptive sampling ------------------------------------------------
    from raytracingincuda_torch.ops import adaptive as ad
    from raytracingincuda_torch.ops.tracer import linear_to_gamma

    def adaptive_cfg(**kw):
        return RenderConfig(impl="adaptive", **kw)

    # the card against the plain versions: the user's entry point on the
    # card, render_adaptive on both
    t_phase = time.perf_counter()
    record["adaptive_compare"] = []
    for rounds in (1, 2):
        cfg = adaptive_cfg(scene_id=1, width=64, height=40, samples=4,
                           bounces=6, max_samples=16, adaptive_tol=0.1,
                           adaptive_rounds=rounds)
        kw = dict(base_spp=4, max_spp=16, tol=0.1, rounds=rounds)
        s = build_scene(1, device=dev)
        card = ad.render_adaptive(s, cam, 64, 40, 6, **kw)
        via_renderer = make_renderer(cfg, dev)(s, cam)
        plain = ad.render_adaptive(build_scene(1, device="cpu"), cam, 64, 40,
                                   6, **kw)
        pa = rk.render_kernel(s, cam, 64, 40, 2, 6, gamma=False,
                              accumulate_only=True)
        pb = rk.render_kernel(s, cam, 64, 40, 2, 6, gamma=False,
                              accumulate_only=True, sample_offset=2)
        base = linear_to_gamma((pa + pb) / 4.0)
        mask = card.spp_map == 4
        out = {"rounds": rounds,
               "renderer_equals_render_adaptive": bool(torch.equal(
                   via_renderer, card.image)),
               "image_bit_equal": bool(torch.equal(card.image.cpu(),
                                                   plain.image)),
               "spp_equal": bool(torch.equal(card.spp_map.cpu(),
                                             plain.spp_map)),
               "zero_extra_pixels": int(mask.sum()),
               "zero_extra_equal_probes": bool(torch.equal(
                   card.image[mask], base[mask])),
               "spp_min_max": [int(card.spp_map.min()),
                               int(card.spp_map.max())]}
        record["adaptive_compare"].append(out)
        if not (out["renderer_equals_render_adaptive"]
                and out["image_bit_equal"] and out["spp_equal"]
                and out["zero_extra_pixels"] > 0
                and out["zero_extra_equal_probes"]
                and out["spp_min_max"][0] >= 4
                and out["spp_min_max"][1] <= 16
                and out["spp_min_max"][1] > out["spp_min_max"][0]):
            raise AssertionError(f"adaptive card vs plain: {out}")
        say("18 adaptive", f"64x40 base 4 max 16 tol 0.1 rounds {rounds}: "
            f"make_renderer's image is render_adaptive's, bit-equal to the "
            f"plain versions', spp maps equal (spp {out['spp_min_max']}); "
            f"{out['zero_extra_pixels']} zero-extra pixels equal "
            f"gamma((A+B)/4) of the probes")

    def count_syncs(fn):
        """Host syncs of one call of ``fn``: torch's sync debug mode warns
        at each one (copies to the host, item, tolist, and the pageable
        copies to the card that wait for the stream)."""
        import warnings

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message).lower() for w in caught)

    scene = build_scene(1, device=dev)
    W, H, D = 1280, 768, 25
    record["adaptive_headline"] = {}
    for rounds in (1, 2):
        cfg = adaptive_cfg(scene_id=1, width=W, height=H, samples=16,
                           bounces=D, max_samples=256, adaptive_tol=0.05,
                           adaptive_rounds=rounds)
        renderer = make_renderer(cfg, dev)
        reset_counts()
        with RenderTimer(dev) as warm:
            img = renderer(scene, cam)
        times = []
        for _ in range(3):
            with RenderTimer(dev) as t:
                img = renderer(scene, cam)
            times.append(t.ms)
        counts = read_counts(f"18 adaptive headline rounds {rounds}")
        arr = img.cpu().numpy()
        spp = ad.render_adaptive(scene, cam, W, H, D, base_spp=16,
                                 max_spp=256, tol=0.05,
                                 rounds=rounds).spp_map.float()
        syncs = count_syncs(lambda: renderer(scene, cam))
        idle = profiled_idle(lambda: renderer(scene, cam))
        if not (counts["regen_render"] >= 4 and counts["stream_render"] == 0
                and arr.shape == (H, W, 3) and np.isfinite(arr).all()
                and arr.min() >= 0.0 and arr.max() <= 1.0
                and float(spp.min()) >= 16 and float(spp.max()) <= 256):
            raise AssertionError(f"adaptive headline rounds {rounds}: "
                                 f"{counts}, spp [{spp.min()}, {spp.max()}]")
        if rounds == 1:  # phase 23's packed route must equal this
            adaptive_vmem = (img, spp)
        h = record["adaptive_headline"][f"rounds{rounds}"] = {
            "render_ms": times, "warmup_ms": warm.ms, "launches": counts,
            "regen_launches_per_render": counts["regen_render"] / 4,
            "spp_mean": float(spp.mean()), "spp_min": float(spp.min()),
            "spp_max": float(spp.max()), "host_syncs_per_render": syncs,
            "idle": idle}
        say("18 adaptive", f"headline rounds {rounds} (scene 1 {W}x{H}/{D}b "
            f"parity, base 16, max 256, tol 0.05): render_ms "
            f"{', '.join(f'{t:.2f}' for t in times)} (warm-up "
            f"{warm.ms:.2f}); spp mean {h['spp_mean']:.3f} [{h['spp_min']:.0f},"
            f" {h['spp_max']:.0f}]; kernel 1 launches a render "
            f"{h['regen_launches_per_render']:.2f}; host syncs a render "
            f"{syncs}; idle {fmt_idle(idle)}")

    # the refine's pixel order: budget buckets against raster, in pairs
    cap = 256 - 16
    pa = rk.render_kernel(scene, cam, W, H, 8, D, gamma=False,
                          accumulate_only=True)
    pb = rk.render_kernel(scene, cam, W, H, 8, D, gamma=False,
                          accumulate_only=True, sample_offset=8)
    _, extra = ad.plan(pa, pb, torch.full((H, W), 16, dtype=torch.int32,
                                          device=dev), max_spp=256, tol=0.05)
    order = ad.bucket_order(extra, cap, rk.PAD * -(-W * H // rk.PAD))

    def refine(po):
        return rk.render_kernel(scene, cam, W, H, cap, D, gamma=False,
                                accumulate_only=True, sample_offset=16,
                                sample_budgets=extra.reshape(-1),
                                pixel_order=po)

    refine(order)
    refine(None)
    pairs = []
    for _ in range(SORT_PAIRS):
        with RenderTimer(dev) as tb:
            by_bucket = refine(order)
        with RenderTimer(dev) as tr:
            raster = refine(None)
        pairs.append((tb.ms, tr.ms))
    if not torch.equal(by_bucket, raster):
        raise AssertionError("the bucket order changed the refine's sums")
    wins = sum(a < b for a, b in pairs)
    record["adaptive_refine_order"] = {
        "bucket_raster_pairs_ms": pairs, "bucket_wins": wins,
        "extra_mean": float(extra.float().mean()),
        "extra_max": int(extra.max())}
    say("18 adaptive", f"headline refine (extra mean "
        f"{float(extra.float().mean()):.3f}, max {int(extra.max())}): the "
        f"bucket order won {wins} of {SORT_PAIRS} pairs against raster "
        f"(bucket {', '.join(f'{a:.2f}' for a, _ in pairs)}; raster "
        f"{', '.join(f'{b:.2f}' for _, b in pairs)}); sums bit-equal")

    # quality at the headline against a 1024-spp truth from a disjoint
    # window (benchmarks/adaptive_probe.py's cases and error statistics)
    truth_offset, truth_spp = 4096, 1024
    with RenderTimer(dev) as t_truth:
        truth = rk.render_kernel(scene, cam, W, H, truth_spp, D, gamma=False,
                                 sample_offset=truth_offset)

    def errs(img):
        d = (img - truth).abs().mean(-1).reshape(-1)
        return {"err": float(d.mean()),
                "p99": float(torch.quantile(d, 0.99)),
                "p999": float(torch.quantile(d, 0.999))}

    def timed_case(fn):
        """A warm-up, then one timed run (as benchmarks/adaptive_probe.py
        times each case)."""
        fn()
        with RenderTimer(dev) as t:
            out = fn()
        return out, t.ms

    quality = []
    for n in (16, 32, 64, 100):
        img, ms = timed_case(lambda: rk.render_kernel(scene, cam, W, H, n, D,
                                                      gamma=False))
        quality.append({"case": f"uniform_{n}", "ms": ms, "mean_spp": n,
                        **errs(img)})
    for base, mx, tol, rounds in ((16, 256, 0.08, 1), (16, 256, 0.05, 1),
                                  (32, 512, 0.05, 1), (16, 128, 0.1, 1),
                                  (16, 256, 0.05, 2), (16, 256, 0.05, 3),
                                  (32, 512, 0.05, 2)):
        last_spp, last_offset = ad.sample_windows(base, mx, rounds)[-1][-1]
        if last_offset + last_spp > truth_offset:
            raise AssertionError("an adaptive window reaches the truth's")
        res, ms = timed_case(lambda: ad.render_adaptive(
            scene, cam, W, H, D, base_spp=base, max_spp=mx, tol=tol,
            rounds=rounds, gamma=False))
        quality.append({"case": f"adaptive_b{base}_m{mx}_t{tol}_r{rounds}",
                        "ms": ms,
                        "mean_spp": float(res.spp_map.float().mean()),
                        **errs(res.image)})
    for q in quality:
        q["err2_x_ms"] = q["err"] ** 2 * q["ms"]
        q["p99_2_x_ms"] = q["p99"] ** 2 * q["ms"]
        if not all(np.isfinite([q["err"], q["p99"], q["p999"]])):
            raise AssertionError(f"quality case not finite: {q}")
    record["adaptive_quality"] = {"truth_spp": truth_spp,
                                  "truth_offset": truth_offset,
                                  "truth_ms": t_truth.ms, "cases": quality}
    say("18 adaptive", f"quality at the headline against a {truth_spp}-spp "
        f"truth (samples from {truth_offset}, {t_truth.ms:.1f} ms): "
        + "; ".join(f"{q['case']} {q['ms']:.2f} ms spp {q['mean_spp']:.2f} "
                    f"err {q['err']:.5f} p99 {q['p99']:.4f} p99.9 "
                    f"{q['p999']:.4f} err2*ms {q['err2_x_ms']:.4g}"
                    for q in quality))
    del truth, pa, pb, by_bucket, raster
    record["phase_s"] = {"18 adaptive": time.perf_counter() - t_phase}

    # -- 19 adaptive sampling on the stream kernel --------------------------
    t_phase = time.perf_counter()
    w, h = 640, 384
    cfg = adaptive_cfg(scene_id=0, width=w, height=h, samples=4, bounces=10,
                       max_samples=32, adaptive_tol=0.1)
    renderer = make_renderer(cfg, dev)
    renderer.prepare(s100k)
    reset_counts()
    with RenderTimer(dev) as warm:
        img = renderer(s100k, cam)
    times = []
    for _ in range(3):
        with RenderTimer(dev) as t:
            img = renderer(s100k, cam)
        times.append(t.ms)
    counts = read_counts("19 adaptive stream")
    st = sk.reorder_front_to_back(sk.prepare_stream_scene(s100k, block=256),
                                  initialize(cam, w, h).center)
    res = ad.render_adaptive(s100k, cam, w, h, 10, base_spp=4, max_spp=32,
                             tol=0.1, stream=st)
    spp = res.spp_map.float()
    if not (counts["stream_render"] >= 4 and counts["regen_render"] == 0
            and torch.equal(res.image, img)
            and bool(torch.isfinite(img).all())
            and float(spp.min()) >= 4 and float(spp.max()) <= 32):
        raise AssertionError(f"adaptive stream: {counts}, image equal "
                             f"{torch.equal(res.image, img)}")
    small = build_random_scene(200, half_extent=10.0, device="cpu")
    st_cpu = sk.prepare_stream_scene(small, block=64)
    st_dev = sk.StreamScene(st_cpu.scene_mat.to(dev), st_cpu.bounds.to(dev),
                            st_cpu.block, st_cpu.perm.to(dev))
    kw = dict(base_spp=4, max_spp=16, tol=0.1)
    on_card = ad.render_adaptive(
        build_random_scene(200, half_extent=10.0, device=dev), cam, 64, 40,
        6, stream=st_dev, **kw)
    plain = ad.render_adaptive(small, cam, 64, 40, 6, stream=st_cpu, **kw)
    small_eq = (torch.equal(on_card.image.cpu(), plain.image)
                and torch.equal(on_card.spp_map.cpu(), plain.spp_map))
    if not small_eq:
        raise AssertionError("adaptive stream card vs plain differ")
    record["adaptive_stream"] = {
        "render_ms": times, "warmup_ms": warm.ms, "launches": counts,
        "stream_launches_per_render": counts["stream_render"] / 4,
        "spp_mean": float(spp.mean()), "spp_min": float(spp.min()),
        "spp_max": float(spp.max()), "small_card_vs_plain_bit_equal": True}
    say("19 adaptive stream", f"100k spheres {w}x{h}/10b base 4 max 32 tol "
        f"0.1: render_ms {', '.join(f'{t:.2f}' for t in times)} (warm-up "
        f"{warm.ms:.2f}); spp mean {float(spp.mean()):.3f}; kernel 4 "
        f"launches a render {counts['stream_render'] / 4:.2f}; 200 spheres "
        f"64x40 through an explicit stream: card bit-equal to plain")

    record["phase_s"]["19 adaptive stream"] = time.perf_counter() - t_phase

    # -- 20 scene assets and pose recovery ----------------------------------
    t_phase = time.perf_counter()
    from raytracingincuda_torch.examples import joint_recovery, pose_recovery
    from raytracingincuda_torch.models import io as scene_io
    from raytracingincuda_torch.models import reference_scene as refscene

    s1 = build_scene(1, device=dev)
    assets = {}
    with tempfile.TemporaryDirectory() as tmp:
        for ext in ("npz", "csv"):
            path = str(Path(tmp) / f"scene1.{ext}")
            scene_io.save_scene(path, s1)
            loaded = scene_io.load_scene(path, device=dev)
            a, b = (scene_io._scene_to_arrays(x) for x in (s1, loaded))
            assets[ext] = {
                "arrays_equal": all(np.array_equal(a[k], b[k]) for k in a),
                "slots": loaded.num_slots,
                "render_equal": bool(torch.equal(
                    rk.render_kernel(loaded, cam, 320, 192, 10, 25),
                    rk.render_kernel(s1, cam, 320, 192, 10, 25)))}
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        # what cli --scene_id 1 writes at this shape: the renderer's image
        # through write_ppm
        ppm.write_ppm(str(Path(tmp) / "scene_id.ppm"), make_renderer(
            RenderConfig(scene_id=1), dev)(s1, cam).cpu().numpy())
        ppm_bytes = {"scene_id": (Path(tmp) / "scene_id.ppm").read_bytes()}
        lines = {}
        for tag, flags, cfg in (
                ("scene_file", ["--scene_file", str(Path(tmp) / "scene1.npz")],
                 RenderConfig(scene_id=0)),
                ("adaptive", ["--scene_id", "1", "--impl", "adaptive"],
                 RenderConfig(scene_id=1, impl="adaptive"))):
            out_dir = Path(tmp) / tag
            out_dir.mkdir()
            res = subprocess.run(
                [sys.executable, "-m", "raytracingincuda_torch.cli",
                 "--width", "320", "--height", "192", "--outdir",
                 str(out_dir), *flags],
                cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"cli {flags} failed: "
                                     f"{res.stderr[-2000:]}")
            lines[tag] = res.stdout.strip().splitlines()[-1]
            ppm_bytes[tag] = (out_dir / cfg.output_filename()).read_bytes()
            if not re.fullmatch(r"\s*[0-9.]+,\s*[0-9.]+", lines[tag]):
                raise AssertionError(f"cli {flags} printed {lines[tag]!r}")
    h256 = hashlib.sha256()
    for arr in refscene.serial_scene1_arrays():
        h256.update(np.ascontiguousarray(arr, np.float64).tobytes())
    serial = refscene.build_serial_reference_scene(device=dev)
    serial_img = rk.render_kernel(serial, cam, 320, 192, 10, 25)
    assets.update(
        cli_scene_file_equals_scene_id=ppm_bytes["scene_file"]
        == ppm_bytes["scene_id"], cli_lines=lines,
        serial_sha256_matches=h256.hexdigest()
        == refscene.SERIAL_SCENE1_SHA256,
        serial_slots=serial.num_slots,
        serial_active=int(serial.active.sum()),
        serial_render_finite=bool(torch.isfinite(serial_img).all()))
    if not (all(assets[e]["arrays_equal"] and assets[e]["slots"] == 512
                for e in ("npz", "csv"))
            and assets["cli_scene_file_equals_scene_id"]
            and assets["serial_sha256_matches"]
            and (assets["serial_slots"], assets["serial_active"]) == (512, 487)
            and assets["serial_render_finite"]):
        raise AssertionError(f"scene assets: {assets}")
    record["assets"] = assets
    say("20 assets", f"scene 1 round-trips through .npz and .csv on the card "
        f"(arrays equal, 512 slots; renders equal: npz "
        f"{assets['npz']['render_equal']}, csv "
        f"{assets['csv']['render_equal']}); cli --scene_file writes the "
        f"--scene_id 1 PPM bytes ({lines['scene_file'].strip()}); cli --impl "
        f"adaptive {lines['adaptive'].strip()}; the serial scene's sha256 "
        f"matches the pin (487 spheres in 512 slots)")

    record["pose"] = {}
    for name, example in (("pose_recovery", pose_recovery),
                          ("joint_recovery", joint_recovery)):
        out, err = io.StringIO(), io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = example.main(["--device", "cuda"])
        secs = time.perf_counter() - t0
        counts = read_counts(f"20 {name}")
        text = out.getvalue() + err.getvalue()
        final = [ln for ln in text.splitlines()
                 if ln.startswith(("recovered", "final"))]
        need = ("regen_render",) + (("grad_render",)
                                    if name == "joint_recovery" else ())
        if rc not in (0, 1) or not final or min(counts[k] for k in need) < 1:
            raise AssertionError(f"{name}: rc {rc}, {counts}, {text[-2000:]}")
        record["pose"][name] = {"rc": rc, "final": final[-1], "secs": secs,
                                "launches": counts}
        say("20 pose", f"{name} --device cuda (defaults): rc {rc} in "
            f"{secs:.1f} s; {final[-1].strip()}; launches {nonzero(counts)}")
    record["phase_s"]["20 assets and pose"] = time.perf_counter() - t_phase

    # -- 21 the f64 oracle ---------------------------------------------------
    t_phase = time.perf_counter()
    from raytracingincuda_torch.models.camera import config_from_leaves
    from raytracingincuda_torch.models.scene import Scene, params_from_leaves
    from raytracingincuda_torch.ops import tracer

    f64 = torch.float64

    def to_f64(s, device):
        """A scene and the reference camera in float64 on ``device``."""
        return (Scene(params_from_leaves([t.double().to(device) for t in
                                          param_leaves(s.params)]),
                      s.mat_type.to(device), s.active.to(device)),
                config_from_leaves([t.double().to(device) for t in
                                    config_leaves(cam)]))

    def grad_leaves(out):
        _, (gp, gc) = out
        return [t.detach().cpu() for t in (*param_leaves(gp),
                                           *config_leaves(gc))]

    reset_counts()
    f64_oracle = {}
    # gradients against f64 central differences at the JAX package's own
    # FD shape and tolerances (tests/test_df64.py: scene 2 in slots of 64,
    # 24x16x2spp/4b, h = 1e-6, where no silhouette is crossed)
    sc2, cm2 = to_f64(build_scene(2, pad_to_multiple=64, device="cpu"), dev)
    wimg = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (16, 24, 3))).to(dev)

    def fd_loss(sc, cm):
        return (wimg * tracer.render(sc, cm, 24, 16, 2, 4, dtype=f64,
                                     gamma=False)).sum()

    fd_rows = []
    for name, k, rtol, atol in (("albedo.x", 4, 1e-4, 1e-10),
                                ("radius", 3, 1e-3, 1e-9)):
        x0 = param_leaves(sc2.params)[k]

        def with_leaf(v, k=k):
            leaves = param_leaves(sc2.params)
            leaves[k] = v
            return Scene(params_from_leaves(leaves), sc2.mat_type,
                         sc2.active)

        x = x0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fd_loss(with_leaf(x), cm2), x)
        i = int(g.abs().argmax())
        e = torch.zeros_like(x0)
        e[i] = 1e-6
        fd = float(fd_loss(with_leaf(x0 + e), cm2)
                   - fd_loss(with_leaf(x0 - e), cm2)) / 2e-6
        fd_rows.append((name, float(g[i]), fd, rtol, atol))
    v = cm2.vfov.clone().requires_grad_(True)
    (gv,) = torch.autograd.grad(fd_loss(sc2, cm2._replace(vfov=v)), v)
    fd = float(fd_loss(sc2, cm2._replace(vfov=cm2.vfov + 1e-6))
               - fd_loss(sc2, cm2._replace(vfov=cm2.vfov - 1e-6))) / 2e-6
    fd_rows.append(("vfov", float(gv), fd, 1e-4, 1e-10))
    f64_oracle["fd"] = [dict(leaf=n, grad=g, fd=f, rtol=r, atol=a)
                        for n, g, f, r, a in fd_rows]
    if not all(abs(g - f) <= a + r * abs(f) for _, g, f, r, a in fd_rows):
        raise AssertionError(f"f64 oracle vs FD: {f64_oracle['fd']}")
    # scene 1 (all 512 slots) on the card against the CPU at 32x20x2spp/4b:
    # the image within 1e-12 and the gradients within 1e-8 of each leaf's
    # largest entry plus 1e-15 (tests/test_torch_f64_grad.py's bounds; the
    # card's double sin/cos are not glibc's)
    s1 = build_scene(1, device="cpu")
    tgt = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (20, 32,
                                                                   3)))
    on = {d: to_f64(s1, d) for d in ("cpu", dev)}
    img_d = tracer.render(*on[dev], 32, 20, 2, 4, dtype=f64).cpu()
    img_h = tracer.render(*on["cpu"], 32, 20, 2, 4, dtype=f64)
    g_d = grad_leaves(gradlib.render_grads(*on[dev], tgt.to(dev), 32, 20, 2,
                                           4, dtype=f64))
    g_h = grad_leaves(gradlib.render_grads(*on["cpu"], tgt, 32, 20, 2, 4,
                                           dtype=f64))
    # the largest share of its bound that a gradient entry's difference uses
    grad_err = max(float(((a - b).abs() / (1e-8 * b.abs().max() + 1e-15))
                         .max()) for a, b in zip(g_d, g_h))
    f64_oracle["card_vs_cpu"] = {
        "image_max_abs_err": float((img_d - img_h).abs().max()),
        "image_dtype": str(img_d.dtype), "grad_share_of_bound": grad_err,
        "grads_finite": all(bool(torch.isfinite(t).all()) for t in g_d)}
    if not (img_d.dtype == f64 and f64_oracle["card_vs_cpu"]["grads_finite"]
            and f64_oracle["card_vs_cpu"]["image_max_abs_err"] <= 1e-12
            and grad_err <= 1.0):
        raise AssertionError(f"f64 oracle card vs CPU: {f64_oracle}")
    # the largest image whose autograd graph fits in half the free memory
    # (2 spp, 4 bounces): the graph's bytes a pixel from a 64x40 probe
    sc1, cm1 = on[dev]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gradlib.render_grads(sc1, cm1, torch.rand((40, 64, 3), dtype=f64,
                                              device=dev), 64, 40, 2, 4,
                         dtype=f64)
    per_px = (torch.cuda.max_memory_allocated() - base) / (64 * 40)
    free = torch.cuda.mem_get_info()[0]
    k = min(256, int((0.5 * free / per_px / 15) ** 0.5))
    bw, bh = 5 * k, 3 * k
    torch.cuda.reset_peak_memory_stats()
    with RenderTimer(dev) as t_grad:
        big = gradlib.render_grads(sc1, cm1, torch.rand(
            (bh, bw, 3), dtype=f64, device=dev), bw, bh, 2, 4, dtype=f64)
    big_peak = torch.cuda.max_memory_allocated() / 2**20
    big_finite = all(bool(torch.isfinite(t).all()) for t in grad_leaves(big))
    del big
    # the render alone, beside the f64 kernel's, at that shape: the
    # oracle's ops ran in render_grads just before, so it takes no warm-up
    times = {}
    s1d = build_scene(1, device=dev)
    for impl, n in (("oracle", 2), ("kernel", 3)):
        r = make_renderer(RenderConfig(scene_id=1, width=bw, height=bh,
                                       samples=2, bounces=4, dtype="float64",
                                       impl=impl), dev)
        if impl == "kernel":
            r(s1d, cam)
        times[impl] = []
        for _ in range(n):
            with RenderTimer(dev) as t:
                out64 = r(s1d, cam)
            times[impl].append(t.ms)
        if out64.dtype != f64 or out64.shape != (bh, bw, 3):
            raise AssertionError(f"f64 {impl} image {out64.dtype} "
                                 f"{tuple(out64.shape)}")
    counts = read_counts("21 f64 oracle")
    f64_oracle.update(
        graph_bytes_per_pixel=per_px, largest=[bw, bh, 2, 4],
        grads_ms=t_grad.ms, grads_peak_mib=big_peak, grads_finite=big_finite,
        oracle_render_ms=times["oracle"], f64_kernel_render_ms=times["kernel"],
        launches=counts)
    if not (big_finite and counts["f64_render"] >= 4):
        raise AssertionError(f"f64 oracle at {bw}x{bh}: {f64_oracle}")
    record["f64_oracle"] = f64_oracle
    say("21 f64 oracle", "vs f64 central differences (scene 2, 24x16x2spp/4b"
        ", h 1e-6): " + "; ".join(
            f"{n} {g:.9g} vs {f:.9g}" for n, g, f, _, _ in fd_rows)
        + f" | scene 1 card vs CPU at 32x20x2spp/4b: image "
        f"{f64_oracle['card_vs_cpu']['image_max_abs_err']:.3g}, gradients "
        f"use {grad_err:.3g} of their bound | largest graph: {bw}x{bh}"
        f"x2spp/4b ({per_px / 1024:.1f} KiB a pixel): render_grads "
        f"{t_grad.ms:.1f} ms, peak {big_peak:.1f} MiB, finite | render at "
        f"that shape: oracle {', '.join(f'{t:.2f}' for t in times['oracle'])}"
        f" ms, f64 kernel {', '.join(f'{t:.3f}' for t in times['kernel'])} "
        f"ms")
    record["phase_s"]["21 f64 oracle"] = time.perf_counter() - t_phase

    # -- 22 two ranks on the one card ----------------------------------------
    t_phase = time.perf_counter()
    from raytracingincuda_torch.parallel import worker

    hl = dict(scene_id=1, width=1280, height=768, samples=100, bounces=25)
    small = dict(scene_id=1, width=320, height=192)
    s100 = dict(scene_id=0, n_spheres=100_000, width=640, height=384,
                bounces=10)
    ad = dict(scene_id=1, width=64, height=40, samples=4, max_samples=16,
              adaptive_tol=0.1, bounces=25)
    jobs = [
        dict(job="render", impl="kernel", tag="warmup", scene_id=1,
             width=64, height=40, samples=2, bounces=4),
        dict(job="render", impl="kernel", tag="headline_parity", **hl),
        dict(job="render", impl="kernel", rr_start=2, tag="headline_rr2",
             stitch=False, **hl),
        dict(job="fused", rr_start=2, order="difficulty", tag="fused", **hl),
        dict(job="grads", impl="kernel", rr_start=2, samples=4, bounces=8,
             tag="grads_kernel", **small),
        dict(job="kernel", mode="compact", samples=10, bounces=25,
             tag="compact", **small),
        dict(job="render", impl="stream", samples=10, tag="stream_render",
             **s100),
        dict(job="stream_train", samples=4, tag="stream_train", **s100),
        dict(job="adaptive", tag="adaptive_r1", **ad),
        dict(job="adaptive", rounds=2, tag="adaptive_r2", **ad),
    ]
    defaults = dict(rr_start=None, impl="kernel")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    two_ranks = {}
    with tempfile.TemporaryDirectory() as tmp:
        two, one = Path(tmp) / "two", Path(tmp) / "one"
        two.mkdir()
        one.mkdir()
        (two / "jobs.json").write_text(json.dumps(jobs))
        res = worker.torchrun(
            ["-m", "raytracingincuda_torch.parallel.worker", "--device",
             "cuda", "--backend", "gloo", "--outdir", str(two), "--jobs",
             str(two / "jobs.json")], timeout=600, env=env, cwd=str(two))
        if res.returncode != 0:
            raise AssertionError(f"two ranks failed: {res.stderr[-3000:]}")
        ranks = json.loads(res.stdout.strip().splitlines()[-1])["ranks"]

        def load(d, tag, rank=0):
            with np.load(d / f"{tag}_r{rank}.npz") as z:
                return {k: z[k] for k in z.files}

        # the same jobs in this process (one rank): the references
        single = {job["tag"]: worker.run_job(job, defaults, "cuda", str(one))
                  for job in jobs[3:6] + jobs[7:]}
        checks = {}
        want = {"headline_parity": headline_imgs["parity"],
                "headline_rr2": headline_imgs["rr2"],
                "stream_render": stream_headline_img}
        for tag, img in want.items():
            checks[tag] = all(np.array_equal(load(two, tag, r)["out"],
                                             img.cpu().numpy())
                              for r in (0, 1))
        for tag in ("compact", "adaptive_r1", "adaptive_r2"):
            a = load(one, tag)
            checks[tag] = all(all(np.array_equal(load(two, tag, r)[k], a[k])
                                  for k in a) for r in (0, 1))
        grad_errs = {}
        for tag, loss_key in (("fused", "out.0"), ("grads_kernel", "out.0"),
                              ("stream_train", "out.1")):
            a, b, b1 = load(one, tag), load(two, tag), load(two, tag, 1)
            # the largest share of its bound that an entry's difference uses
            worst = {}
            ok = all(np.array_equal(b[k], b1[k]) for k in b)
            for k in a:
                if k == loss_key:
                    worst["loss"] = abs(float(b[k]) - float(a[k])) / (
                        1e-6 * abs(float(a[k])))
                elif a[k].dtype.kind in "iub" or k == "out.1" and tag == \
                        "fused":
                    ok &= bool(np.array_equal(a[k], b[k]))
                else:
                    worst["rest"] = max(worst.get("rest", 0.0), float(
                        (np.abs(b[k] - a[k]) / (1e-7 + 1e-4 * np.abs(a[k])))
                        .max()))
            ok &= max(worst.values()) <= 1.0
            grad_errs[tag] = worst
            recs = [next(j for j in rk_["jobs"] if j["tag"] == tag)
                    for rk_ in ranks]
            checks[tag] = ok and all(r["runs_bit_identical"] for r in recs)
            if tag in ("fused", "stream_train"):
                checks[tag] &= all(r["all_reduces_a_step"] == 1 for r in recs)
        checks["ppm_identical"] = next(
            j for j in ranks[0]["jobs"]
            if j["tag"] == "headline_parity")["ppm_identical"]
        ppm.write_ppm(str(two / "phase4.ppm"),
                      headline_imgs["parity"].cpu().numpy())
        checks["stitched_is_phase4"] = ((two / "headline_parity.stitched.ppm")
                                        .read_bytes()
                                        == (two / "phase4.ppm").read_bytes())
        # the CLI under torchrun against one process's image
        cli_dir = Path(tmp) / "cli"
        cli_dir.mkdir()
        t0 = time.perf_counter()
        res = worker.torchrun(
            ["-m", "raytracingincuda_torch.cli", "--devices", "2",
             "--scene_id", "1", "--width", "320", "--height", "192",
             "--outdir", str(cli_dir)], timeout=300, env=env,
            cwd=str(cli_dir))
        cli_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"torchrun cli failed: {res.stderr[-3000:]}")
        cli_lines = res.stdout.strip().splitlines()
        ppm.write_ppm(str(cli_dir / "one.ppm"), make_renderer(
            RenderConfig(scene_id=1), dev)(build_scene(1, device=dev),
                                           cam).cpu().numpy())
        checks["cli_bytes_equal"] = (
            (cli_dir / RenderConfig(scene_id=1).output_filename())
            .read_bytes() == (cli_dir / "one.ppm").read_bytes()
            and len(cli_lines) == 1)
    by_rank = {}
    for r in ranks:
        tot: dict = {}
        for j in r["jobs"]:
            for name, n in j["launches"].items():
                tot[name] = tot.get(name, 0) + n
        by_rank[r["rank"]] = tot
        record["launches_by_phase"][f"22 two ranks, rank {r['rank']}"] = tot
        for name, n in tot.items():
            main_launches[name] += n
    need = ("regen_render", "fused_train_render", "grad_render",
            "compact_render", "stream_render", "stream_train",
            "stream_segment_sum")
    two_ranks.update(
        ranks=ranks, checks=checks, grad_err_over_leaf_max=grad_errs,
        single_secs={k: v["secs"] for k, v in single.items()},
        cli_line=cli_lines[-1], cli_s=cli_s, launches_by_rank=by_rank)
    record["two_ranks"] = two_ranks
    if not (all(checks.values()) and all(min(by_rank[r].get(n, 0)
                                             for n in need) >= 1
                                         for r in (0, 1))):
        raise AssertionError(f"two ranks: {checks}, {by_rank}")
    secs = {j["tag"]: j["secs"] for j in ranks[0]["jobs"]}
    steps = {}
    for tag in ("fused", "stream_train"):
        recs = [next(j for j in r["jobs"] if j["tag"] == tag) for r in ranks]
        steps[tag] = {
            "two_ranks_run_s": [r["run_secs"] for r in recs],
            "two_ranks_all_reduce_s": [r["all_reduce_secs"] for r in recs],
            "two_ranks_peak_mib": [r.get("peak_mib") for r in recs],
            "one_process_run_s": single[tag]["run_secs"],
            "one_process_peak_mib": single[tag].get("peak_mib")}
    two_ranks["steps"] = steps
    say("22 two ranks", "two gloo ranks sharing one card (torchrun): the "
        "headline parity and rr2 images, the 100k stream image, compact and "
        "adaptive (rounds 1, 2) bit-equal to one process; PPM via parts + "
        "stitch = phase 4's bytes; fused step (phase 7's config), kernel 3 "
        "grads and the 100k stream step within loss rtol 1e-6 and rtol 1e-4"
        "/atol 1e-7 (share of the bound used: " + ", ".join(
            f"{k} loss {v['loss']:.3g}, rest {v['rest']:.3g}"
            for k, v in grad_errs.items())
        + "), bit-identical run to run, one "
        f"all_reduce a fused step; torchrun cli bytes equal ({cli_s:.1f} s);"
        " rank 0 seconds (two ranks sharing one card): " + ", ".join(
            f"{k} {v:.2f}" for k, v in secs.items())
        + "; a step's two runs (s) and their all_reduce seconds by rank, "
        "against one process: " + "; ".join(
            f"{k} {v['two_ranks_run_s']} ({v['two_ranks_all_reduce_s']}) "
            f"vs {v['one_process_run_s']}, peak MiB {v['two_ranks_peak_mib']}"
            f" vs {v['one_process_peak_mib']}" for k, v in steps.items())
        + f"; launches by rank {by_rank}")
    record["phase_s"]["22 two ranks"] = time.perf_counter() - t_phase

    # -- 23 routes -----------------------------------------------------------
    t_phase = time.perf_counter()
    from raytracingincuda_torch import cli as cli_mod
    from raytracingincuda_torch import render_api
    from raytracingincuda_torch.ops import adaptive as adaptive_mod
    from raytracingincuda_torch.utils import checkpoint as ckpt

    routes = {}
    # impl='adaptive' with layout='packed' is the adaptive renderer (kernel
    # 1 at this slot count), equal to phase 18's vmem headline, rounds 1
    calls = []
    real_adaptive = adaptive_mod.render_adaptive

    def spy_adaptive(*a, **k):
        out = real_adaptive(*a, **k)
        calls.append(out.spp_map.float())
        return out

    adaptive_mod.render_adaptive = spy_adaptive
    try:
        renderer = make_renderer(adaptive_cfg(
            scene_id=1, width=W, height=H, samples=16, bounces=D,
            max_samples=256, adaptive_tol=0.05, layout="packed"), dev)
        reset_counts()
        with RenderTimer(dev) as t_packed:
            img = renderer(scene, cam)
        counts = read_counts("23 routes adaptive packed")
    finally:
        adaptive_mod.render_adaptive = real_adaptive
    routes["adaptive_packed"] = {
        "render_adaptive_calls": len(calls), "launches": nonzero(counts),
        "render_ms": t_packed.ms,
        "image_equal_phase18": bool(torch.equal(img, adaptive_vmem[0])),
        "spp_equal_phase18": bool(len(calls) == 1 and torch.equal(
            calls[0], adaptive_vmem[1]))}
    if not (len(calls) == 1 and counts["regen_render"] >= 1
            and counts["stream_render"] == 0
            and routes["adaptive_packed"]["image_equal_phase18"]
            and routes["adaptive_packed"]["spp_equal_phase18"]):
        raise AssertionError(f"adaptive packed route: {routes}")
    del img, adaptive_vmem
    # the f64 oracle takes rr_start and legacy_sky: the card against the
    # CPU at phase 21's bar, on scene 1 built in float64 (as the CLI does)
    f64_routes = {}
    for name, kw in (("rr2", dict(rr_start=2)),
                     ("legacy_sky", dict(legacy_sky=True))):
        cfg = RenderConfig(scene_id=1, width=32, height=20, samples=2,
                           bounces=4, impl="oracle", dtype="float64", **kw)
        cam64 = CameraConfig.reference_default(dtype=f64)
        got = make_renderer(cfg, dev)(build_scene(1, dtype=f64, device=dev),
                                      cam64).cpu()
        want = make_renderer(cfg, "cpu")(
            build_scene(1, dtype=f64, device="cpu"), cam64)
        f64_routes[name] = float((got - want).abs().max())
        if not (got.dtype == f64 and f64_routes[name] <= 1e-12):
            raise AssertionError(f"f64 oracle {name} card vs CPU: "
                                 f"{f64_routes}")
    routes["f64_oracle_card_vs_cpu_max_abs_err"] = f64_routes
    # render_incremental at float64 in two rounds on the card: the sum
    # stays double, within 1e-12 of the one-shot f64 oracle on the card
    cfg = RenderConfig(scene_id=1, width=32, height=20, samples=4, bounces=4,
                       impl="oracle", dtype="float64")
    s64 = build_scene(1, dtype=f64, device=dev)
    inc = ckpt.render_incremental(s64, cam64, cfg, samples_per_round=2)
    one = make_renderer(cfg, dev)(s64, cam64).cpu().numpy()
    routes["incremental_f64_max_abs_err"] = float(np.abs(inc - one).max())
    if not (inc.dtype == np.float64
            and routes["incremental_f64_max_abs_err"] <= 1e-12):
        raise AssertionError(f"render_incremental float64: {routes}")
    # with impl='kernel' a float64 config renders each round on the f64
    # kernel, a window of samples at the round's sample_offset, and never
    # on the oracle: two rounds within 1e-12 of one make_renderer render
    from raytracingincuda_torch.ops import tracer as tracer_mod

    cfg = RenderConfig(scene_id=1, width=320, height=192, samples=4,
                       bounces=25, dtype="float64")
    s1d = build_scene(1, device=dev)
    oracle_calls = []
    real_oracle = tracer_mod.render
    tracer_mod.render = lambda *a, **k: (oracle_calls.append(1)
                                         or real_oracle(*a, **k))
    try:
        reset_counts()
        inc = ckpt.render_incremental(s1d, cam, cfg, samples_per_round=2)
        counts = read_counts("23 routes incremental f64 kernel")
    finally:
        tracer_mod.render = real_oracle
    one = make_renderer(cfg, dev)(s1d, cam).cpu().numpy()
    routes["incremental_f64_kernel"] = {
        "launches": nonzero(counts), "oracle_calls": len(oracle_calls),
        "max_abs_err": float(np.abs(inc - one).max())}
    if not (counts["f64_render"] == 2 and not oracle_calls
            and sum(counts.values()) == 2 and inc.dtype == np.float64
            and inc.shape == (192, 320, 3) and np.isfinite(inc).all()
            and routes["incremental_f64_kernel"]["max_abs_err"] <= 1e-12):
        raise AssertionError(f"render_incremental float64 kernel: {routes}")
    # render_incremental with impl='kernel', layout='packed': kernel 4 in
    # two rounds, against one render_stream render over the same stream
    # (f32 sums in another order: within 1e-6)
    cfg = RenderConfig(scene_id=1, width=320, height=192, samples=4,
                       bounces=25, layout="packed")
    reset_counts()
    inc = ckpt.render_incremental(s1d, cam, cfg, samples_per_round=2)
    counts = read_counts("23 routes incremental packed")
    one = sk.render_stream(make_renderer(cfg, dev).prepare(s1d, cam), cam,
                           320, 192, 4, 25).cpu().numpy()
    routes["incremental_packed"] = {
        "launches": nonzero(counts),
        "max_abs_err": float(np.abs(inc - one).max())}
    if not (counts["stream_render"] == 2 and counts["regen_render"] == 0
            and routes["incremental_packed"]["max_abs_err"] <= 1e-6):
        raise AssertionError(f"render_incremental packed: {routes}")
    # the CLI's f64 oracle: a float64 scene and camera, rc 0, its PPM the
    # renderer's image
    seen = []
    real_mr = render_api.make_renderer

    def spy_renderer(cfg, *a, **k):
        r = real_mr(cfg, *a, **k)

        def wrapped(sc, cm):
            seen.append((str(sc.params.radius.dtype), str(cm.vfov.dtype)))
            return r(sc, cm)
        return wrapped

    render_api.make_renderer = spy_renderer
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli_mod.main(["--scene_id", "1", "--width", "64",
                                   "--height", "40", "--samples", "2",
                                   "--bounces", "4", "--dtype", "float64",
                                   "--impl", "oracle", "--rr_start", "2",
                                   "--no-warmup", "--outdir", tmp])
            cfg = RenderConfig(scene_id=1, width=64, height=40, samples=2,
                               bounces=4, dtype="float64", impl="oracle",
                               rr_start=2)
            got, _ = ppm.read_ppm(str(Path(tmp) / cfg.output_filename()))
    finally:
        render_api.make_renderer = real_mr
    want = make_renderer(cfg, dev)(build_scene(1, dtype=f64, device=dev),
                                   cam64).cpu().numpy()
    routes["cli_f64_oracle"] = {"rc": rc, "line": out.getvalue().strip(),
                                "scene_camera_dtypes": seen,
                                "ppm_equal": bool(np.array_equal(
                                    got, ppm.quantize(want)))}
    if not (rc == 0 and seen == [("torch.float64", "torch.float64")]
            and routes["cli_f64_oracle"]["ppm_equal"]):
        raise AssertionError(f"cli --dtype float64 --impl oracle: {routes}")
    record["routes"] = routes
    say("23 routes", f"adaptive headline with layout packed: one "
        f"render_adaptive call, launches "
        f"{routes['adaptive_packed']['launches']}, "
        f"{t_packed.ms:.2f} ms, image and spp map bit-equal to phase 18's "
        f"vmem render | f64 oracle card vs CPU (32x20x2spp/4b): rr2 "
        f"{f64_routes['rr2']:.3g}, legacy_sky {f64_routes['legacy_sky']:.3g}"
        f" | render_incremental f64 two rounds vs one-shot: "
        f"{routes['incremental_f64_max_abs_err']:.3g}; impl kernel on the "
        f"f64 kernel (320x192x4spp/25b) "
        f"{routes['incremental_f64_kernel']['max_abs_err']:.3g}, "
        f"{routes['incremental_f64_kernel']['launches']}, no oracle call"
        f" | packed two rounds "
        f"vs render_stream (320x192x4spp/25b): "
        f"{routes['incremental_packed']['max_abs_err']:.3g}, "
        f"{routes['incremental_packed']['launches']} | cli --dtype float64 "
        f"--impl oracle --rr_start 2: rc 0, float64 scene and camera, PPM "
        f"equal to the renderer's")
    record["phase_s"]["23 routes"] = time.perf_counter() - t_phase

    # -- 24 train checkpoints of any optimizer --------------------------------
    t_phase = time.perf_counter()
    from raytracingincuda_torch.ops import grad as grad24

    def state_equal(a, b) -> bool:
        """Params, count, step and every per-leaf optimizer state entry
        equal: keys, kinds, devices, dtypes and bits."""
        pairs = [*zip(param_leaves(a.params), param_leaves(b.params)),
                 (a.opt_state.count, b.opt_state.count), (a.step, b.step)]
        for sa, sb in zip(a.opt_state.per_leaf, b.opt_state.per_leaf):
            if list(sa) != list(sb):
                return False
            for k in sa:
                if not torch.is_tensor(sb[k]):
                    if type(sa[k]) is not type(sb[k]) or sa[k] != sb[k]:
                        return False
                    continue
                pairs.append((sa[k], sb[k]))
        return a.opt_state.name == b.opt_state.name and all(
            torch.is_tensor(x) and x.device == y.device
            and x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs)

    scene24 = build_scene(1, device=dev)
    w24, h24, spp24, d24 = 320, 192, 4, 8
    tgt24 = rk.render_kernel(scene24, cam, w24, h24, spp24, d24, gamma=False)
    gray = torch.full_like(scene24.params.albedo.x, 0.5)
    start24 = scene24.params._replace(albedo=Vec3(gray, gray, gray))
    mask24 = SceneParams(Vec3(False, False, False), False,
                         Vec3(True, True, True), True, False)
    optimizers = {
        "sgd_momentum": functools.partial(torch.optim.SGD, lr=2e-2,
                                          momentum=0.9),
        "adamw": functools.partial(torch.optim.AdamW, lr=2e-2,
                                   weight_decay=0.05)}
    ckpts = {}
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for name, factory in optimizers.items():
            init24, step24 = grad24.make_train_step(
                w24, h24, spp24, d24, factory, trainable=mask24,
                impl="fused")

            def steps(state, n):
                losses = []
                for _ in range(n):
                    state, loss = step24(state, cam, scene24.mat_type,
                                         scene24.active, tgt24)
                    losses.append(float(loss))
                return state, losses

            straight, losses = steps(init24(start24), 3)
            one, _ = steps(init24(start24), 1)
            path = str(Path(tmp) / name)
            ckpt.save_train_state(path, one, token=name)
            loaded = ckpt.load_train_state(path, init24(start24), token=name)
            resumed, _ = steps(loaded, 2)
            ckpts[name] = {
                "losses": losses, "loaded_equal": state_equal(loaded, one),
                "resumed_equal": state_equal(resumed, straight),
                "albedo_moved": float((straight.params.albedo.x
                                       - gray).abs().max()),
                "state_keys": sorted({k for st in straight.opt_state.per_leaf
                                      for k in st})}
            if not (ckpts[name]["loaded_equal"]
                    and ckpts[name]["resumed_equal"]
                    and all(np.isfinite(losses))
                    and ckpts[name]["albedo_moved"] > 0.0):
                raise AssertionError(f"train checkpoint {name}: {ckpts}")
    counts = read_counts("24 train checkpoints")
    if not (counts["fused_train_render"] >= 24
            and counts["fused_train_render"] % 2 == 0):
        raise AssertionError(f"train checkpoints launches: {counts}")
    record["train_checkpoints"] = dict(ckpts, launches=nonzero(counts))
    say("24 train ckpt", f"make_train_step(impl='fused') at scene 1 "
        f"{w24}x{h24}x{spp24}spp/{d24}b: "
        + "; ".join(f"{k} 3 steps straight vs 1 + save/load + 2: params "
                    f"and state {v['state_keys']} bit-equal, loss "
                    f"{v['losses'][0]:.6g} -> {v['losses'][-1]:.6g}, albedo "
                    f"moved {v['albedo_moved']:.3g}"
                    for k, v in ckpts.items())
        + f" | launches {nonzero(counts)}")
    record["phase_s"]["24 train checkpoints"] = time.perf_counter() - t_phase

    # -- 25 deep paths and record windows -------------------------------------
    t_phase = time.perf_counter()
    from raytracingincuda_torch.models.scene import Scene as Scene25
    from raytracingincuda_torch.models.scene import build_deep_scene
    from raytracingincuda_torch.ops import grad as grad25

    phase = "25 deep"
    # kernels 2 and 3 past the shallow stack, on the deep scene (the 256
    # instance), against their plain versions
    deep25 = build_deep_scene(device=dev)
    w25, h25, spp25, d25 = 160, 96, 2, 128
    in25 = rk.regen_inputs(deep25, cam, w25, h25, spp25)
    gen = torch.Generator().manual_seed(25)
    g25 = (torch.randn((3, in25[0].shape[0]), generator=gen) * 1e-3).to(dev)
    tgt25 = torch.rand((3, in25[0].shape[0]), generator=gen).to(dev)
    grad_in25 = (*in25[:3], g25, *in25[4:])
    fused_in25 = (*in25[:3], tgt25, *in25[4:])
    deep_rows = []
    for rr in (None, 2):
        kw = dict(samples=spp25, max_depth=d25, rr_start=rr)
        ends = tk.path_ends(*in25[:3], *in25[4:], **kw)[:, :w25 * h25]
        banked = ends[ends > 0]
        share = float((banked > tk.STACK_SHALLOW).double().mean())
        a_out, a_ms = timed(lambda: tk.grad_kernel(*grad_in25, **kw), 3)
        a_again = tk.grad_kernel(*grad_in25, **kw)
        a_plain, a_plain_ms = timed(lambda: tk.grad_reference(*grad_in25,
                                                              **kw), 1,
                                    warm=False)
        fkw = dict(kw, num_pixels=w25 * h25)
        b_out, b_ms = timed(lambda: tk.fused_train_kernel(*fused_in25, **fkw),
                            3)
        b_again = tk.fused_train_kernel(*fused_in25, **fkw)
        b_plain, b_plain_ms = timed(lambda: tk.fused_train_reference(
            *fused_in25, **fkw), 1, warm=False)
        img = rk.regen_kernel(*in25, samples=spp25, max_depth=d25,
                              rr_start=rr, finalize_scale=1.0 / spp25)
        segs = float(rk.regen_kernel(*in25, samples=spp25, max_depth=d25,
                                     rr_start=rr, emit_depth=True)
                     .double().sum())
        n25 = deep25.num_slots
        lanes25 = in25[0].shape[0]
        res = {"shape": f"{w25}x{h25}x{spp25}spp/{d25}b", "rr_start": rr,
               "banked_paths": int(banked.numel()),
               "past_64_share": share, "deepest_bounce": int(banked.max()),
               "grad_ms": a_ms, "grad_plain_ms": a_plain_ms,
               "fused_ms": b_ms, "fused_plain_ms": b_plain_ms,
               "grad_bound": bound(segs * n25 * OPS_TEST_STAGED,
                                   lanes25 * 24 + n25 * (44 + 64)),
               "fused_bound": bound(segs * n25 * OPS_TEST_STAGED,
                                    lanes25 * 36 + n25 * (44 + 64)),
               "run_to_run_identical": all(
                   torch.equal(x, y) for x, y in zip((*a_out, *b_out),
                                                     (*a_again, *b_again))),
               "image_equals_plain": bool(torch.equal(b_out[1], b_plain[1])),
               "image_equals_regen": bool(torch.equal(b_out[1], img)),
               "grad": grad_compare(a_out, a_plain, ("d_scene", "d_cam")),
               "fused": grad_compare(
                   (b_out[0].reshape(1), b_out[2], b_out[3]),
                   (b_plain[0].reshape(1), b_plain[2], b_plain[3]),
                   ("loss", "d_scene", "d_cam"))}
        deep_rows.append(res)
        if not (res["run_to_run_identical"] and res["image_equals_plain"]
                and res["image_equals_regen"] and share >= 0.01
                and all(v["ok"] for v in (*res["grad"].values(),
                                          *res["fused"].values()))):
            raise AssertionError(f"deep instance vs plain: {res}")
        say(phase, f"256 instance, deep scene {res['shape']} rr={rr}: "
            f"{100 * share:.2f}% of {res['banked_paths']} banking paths end "
            f"beyond bounce 64 (deepest {res['deepest_bounce']}); kernel 3 "
            f"{a_ms:.3f} ms (plain {a_plain_ms:.1f}, bound "
            f"{res['grad_bound'][0]:.4f}), d_scene max|d|/max "
            f"{res['grad']['d_scene']['max_rel_to_largest']:.3g}; kernel 2 "
            f"{b_ms:.3f} ms (plain {b_plain_ms:.1f}, bound "
            f"{res['fused_bound'][0]:.4f}), image bit-equal to plain and "
            f"regen, loss rel {res['fused']['loss']['max_rel_to_largest']:.3g}"
            f", d_scene {res['fused']['d_scene']['max_rel_to_largest']:.3g};"
            f" run-to-run identical")
    # the two instances at depth 64 (forced), in turns: the same bits
    head_in25 = rk.regen_inputs(build_scene(1, device=dev), cam, 1280, 768, 2)
    head_tgt25 = torch.rand((3, head_in25[0].shape[0]), generator=gen).to(dev)
    instances = {
        "kernel 3 320x192x4spp/8b rr2 (row 3)": lambda st: tk.grad_kernel(
            *grad_in, samples=4, max_depth=8, rr_start=2, stack=st),
        "kernel 2 1280x768x2spp/25b rr2 (row 2)":
            lambda st: tk.fused_train_kernel(
                *head_in25[:3], head_tgt25, *head_in25[4:], samples=2,
                max_depth=25, rr_start=2, num_pixels=1280 * 768, stack=st),
        "kernel 3 deep 160x96x2spp/64b rr2": lambda st: tk.grad_kernel(
            *grad_in25, samples=2, max_depth=64, rr_start=2, stack=st),
        "kernel 2 deep 160x96x2spp/64b rr2": lambda st: tk.fused_train_kernel(
            *fused_in25, samples=2, max_depth=64, rr_start=2,
            num_pixels=w25 * h25, stack=st)}
    stack_ms = {}
    for name, fn in instances.items():
        outs, ms = {}, {tk.STACK_SHALLOW: [], tk.MAX_DEPTH: []}
        for st in (tk.STACK_SHALLOW, tk.MAX_DEPTH) * 2:
            outs[st], t_ms = timed(lambda: fn(st), 3)
            ms[st].append(t_ms)
        equal = all(torch.equal(a, b) for a, b in
                    zip(outs[tk.STACK_SHALLOW], outs[tk.MAX_DEPTH]))
        stack_ms[name] = {"ms_64": ms[tk.STACK_SHALLOW],
                          "ms_256": ms[tk.MAX_DEPTH], "bit_equal": equal}
        if not equal:
            raise AssertionError(f"stack instances differ: {name}")
        say(phase, f"{name}: 64 instance {min(ms[tk.STACK_SHALLOW]):.3f} ms,"
            f" 256 instance {min(ms[tk.MAX_DEPTH]):.3f} ms "
            f"({min(ms[tk.MAX_DEPTH]) / min(ms[tk.STACK_SHALLOW]):.2f}x), "
            f"outputs bit-equal")
    # the main paths at depth 128: make_mse_train and render_kernel_grads
    reset_counts()
    step25 = tk.make_mse_train(deep25.mat_type, deep25.active, w25, h25,
                               spp25, d25, rr_start=2)
    loss25, img25, _ = step25(deep25.params, cam,
                              torch.rand((h25, w25, 3), generator=gen).to(dev))
    dsm25, dcr25 = tk.render_kernel_grads(deep25, cam,
                                          torch.ones((h25, w25, 3)), w25, h25,
                                          spp25, d25)
    deep_counts = read_counts("25 deep paths (depth 128)")
    if not (deep_counts["fused_train_render"] >= 2
            and deep_counts["grad_render"] >= 1
            and bool(torch.isfinite(loss25)) and bool(
                torch.isfinite(dsm25).all())):
        raise AssertionError(f"deep main paths: {deep_counts}")
    # today's instance and route unchanged: phases 7 and 12 against the
    # ranges PERF.md section 5 records for this card's model, within 2%
    unchanged = {
        "7 fused step": (min(record["train"]["fused_train_step_ms"]),
                         145.48, 146.06),
        "12 stream step": (min(record["stream_train"]["fused_step_ms"]),
                           49.74, 52.47)}
    unchanged = {k: {"best_ms": v[0], "range_ms": [v[1], v[2]],
                     "within_2pct": 0.98 * v[1] <= v[0] <= 1.02 * v[2]}
                 for k, v in unchanged.items()}
    say(phase, "; ".join(f"phase {k} best {v['best_ms']:.2f} ms against "
                         f"{v['range_ms'][0]}-{v['range_ms'][1]} ms: within "
                         f"2% {v['within_2pct']}"
                         for k, v in unchanged.items()))

    phase = "25 windows"
    # kernel 5 in forced windows (chunks of lanes and samples) against its
    # plain version in the same windows, at 64x40
    s1k = build_random_scene(1000, seed=3, device=dev)
    st1k = sk.prepare_stream_scene(s1k, block=64)
    ids, ii, jj, _, row = lanes(64, 40, 4)
    g1k = (torch.randn((3, ids.shape[0]), generator=gen) * 1e-3).to(dev)
    w_budget = 7 * rk.PAD * 6 * stk.PLAN_BYTES
    w_args = (ids, ii, jj, g1k, st1k.scene_mat, st1k.bounds, row)
    w_kw = dict(block=64, samples=4, max_depth=6, rr_start=2,
                budget=w_budget)
    n_win = len(stk.plan_records(ids.shape[0], 4, 6, w_budget))
    before = trace.counts().get("launch.stream_train", 0)
    win_out = stk.stream_grads_kernel(*w_args, **w_kw)
    win_again = stk.stream_grads_kernel(*w_args, **w_kw)
    torch.cuda.synchronize()
    win_launches = trace.counts().get("launch.stream_train", 0) - before
    win_plain = stk.stream_grads_reference(*w_args, **w_kw)
    win_res = {"windows": n_win, "launches": win_launches,
               "run_to_run_identical": all(torch.equal(a, b) for a, b in
                                           zip(win_out, win_again)),
               **grad_compare(win_out, win_plain, ("d_stream", "d_cam"))}
    if not (win_res["run_to_run_identical"] and win_launches == 2 * n_win
            and n_win >= 3 and win_res["d_stream"]["ok"]
            and win_res["d_cam"]["ok"]):
        raise AssertionError(f"kernel 5 in windows: {win_res}")
    say(phase, f"kernel 5 gradient mode at 64x40x4spp/6b rr2 in {n_win} "
        f"windows (3 chunks of lanes a sample) vs its plain version in the "
        f"same windows: d_stream max|d|/max "
        f"{win_res['d_stream']['max_rel_to_largest']:.3g}, d_cam "
        f"{win_res['d_cam']['max_rel_to_largest']:.3g}; one launch a window;"
        f" run-to-run identical")
    # phase 12's cell with a forced budget against its one-launch step
    w, h = 640, 384
    stream25 = sk.prepare_stream_scene(s100k)
    st25 = sk.StreamScene(*sk.build_stream_arrays(
        Scene25(s100k.params, s100k.mat_type, s100k.active), stream25.perm,
        stream25.block, stream25.scene_mat.shape[0],
        border=grad25.front_to_back_border(stream25, cam, w, h)),
        stream25.block, stream25.perm)
    tgt100k = torch.rand((h, w, 3), generator=gen).to(dev)
    forced = 100 << 20                  # one sample of 640x384 at 10 bounces
    one = stk.mse_train_stream(st25, cam, tgt100k, w, h, 4, 10)
    reset_counts()
    win = stk.mse_train_stream(st25, cam, tgt100k, w, h, 4, 10,
                               budget=forced)
    forced_counts = read_counts("25 record windows (100k, 640x384x4spp/10b)")
    n_forced = len(stk.plan_records(w * h, 4, 10, forced))
    forced_res = {"windows": n_forced, "launches": nonzero(forced_counts),
                  "loss_one_launch": float(one[0]), "loss_windows":
                  float(win[0]), "loss_bit_equal": bool(torch.equal(one[0],
                                                                    win[0])),
                  **grad_compare(win[1:], one[1:], ("d_stream", "d_cam"))}
    if not (n_forced >= 3 and forced_counts["stream_render"] == 1
            and forced_counts["stream_train"] == n_forced
            and abs(forced_res["loss_windows"] / forced_res["loss_one_launch"]
                    - 1.0) <= 1e-6
            and forced_res["d_stream"]["ok"] and forced_res["d_cam"]["ok"]):
        raise AssertionError(f"forced windows on phase 12's cell: "
                             f"{forced_res}")
    say(phase, f"phase 12's cell (100k, {w}x{h}x4spp/10b) at a budget of "
        f"{forced >> 20} MiB: {n_forced} windows; loss {float(win[0]):.9g} "
        f"against the one-launch {float(one[0]):.9g} (bit-equal "
        f"{forced_res['loss_bit_equal']}); d_stream max|d|/max "
        f"{forced_res['d_stream']['max_rel_to_largest']:.3g}, d_cam "
        f"{forced_res['d_cam']['max_rel_to_largest']:.3g}; launches "
        f"{nonzero(forced_counts)}")
    del one, win
    # the shape that was refused: 100k, 640x384, 100 spp, 25 bounces
    spp_r, d_r = 100, 25
    init_r, step_r = grad25.make_stream_train(stream25, w, h, spp_r, d_r)
    state_r = init_r(s100k.params)
    n_r = len(stk.plan_records(w * h, spp_r, d_r))
    torch.cuda.synchronize()
    base_mib = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times_r, outs_r = [], []
    for _ in range(3):                  # best of 3, each from the same state
        with RenderTimer(dev) as t:
            outs_r.append(step_r(state_r, cam, s100k.mat_type, s100k.active,
                                 tgt100k))
        times_r.append(t.ms)
    refused_counts = read_counts("25 refused shape (100k, 640x384x100spp/25b)")
    peak_r = torch.cuda.max_memory_allocated() / 2**20 - base_mib
    first_r = outs_r[0]
    identical_r = all(
        torch.equal(o[1], first_r[1]) and all(
            torch.equal(a, b) for a, b in zip(param_leaves(o[0].params),
                                              param_leaves(first_r[0].params)))
        for o in outs_r)
    # the largest window's records and their sort (record_order over every
    # record), the budget's share of the peak; the rest is the step's own
    # tensors (image, scene, optimizer state)
    window_mib = max(x.lanes * x.samples for x in stk.plan_records(
        w * h, spp_r, d_r)) * d_r * stk.PLAN_BYTES / 2**20
    refused = {"shape": f"{w}x{h}x{spp_r}spp/{d_r}b", "windows": n_r,
               "step_ms": times_r, "loss": float(first_r[1]),
               "peak_over_base_mib": peak_r,
               "record_budget_mib": stk.RECORD_BUDGET / 2**20,
               "largest_window_records_and_sort_mib": window_mib,
               "run_to_run_identical": identical_r,
               "launches": nonzero(refused_counts)}
    if not (identical_r and np.isfinite(refused["loss"])
            and refused_counts["stream_train"] == 3 * n_r
            and refused_counts["stream_render"] == 3
            and window_mib <= refused["record_budget_mib"]
            and peak_r <= refused["record_budget_mib"] + 256):
        raise AssertionError(f"the refused shape: {refused}")
    say(phase, f"make_stream_train 100k {refused['shape']} (refused before "
        f"record windows): {n_r} windows; step ms "
        f"{', '.join(f'{t:.2f}' for t in times_r)}; peak {peak_r:.1f} MiB "
        f"above the {base_mib:.1f} MiB held before: the largest window's "
        f"records and their sort {window_mib:.1f} MiB (budget "
        f"{refused['record_budget_mib']:.0f} MiB), the step's tensors "
        f"{peak_r - window_mib:.1f} MiB; loss {refused['loss']:.9g},"
        f" bit-identical from run to run; launches {refused['launches']}")
    record["deep_and_windows"] = {
        "deep": deep_rows, "stack_instances": stack_ms,
        "deep_main_path_launches": nonzero(deep_counts),
        "unchanged": unchanged, "kernel5_windows": win_res,
        "forced_windows_step": forced_res, "refused_shape": refused}
    record["phase_s"]["25 deep and windows"] = time.perf_counter() - t_phase
    say(phase, f"phase took {record['phase_s']['25 deep and windows']:.1f} s")

    # -- 26 large images -------------------------------------------------------
    record["large_images"] = large_images(dev, cam, reset_counts, read_counts)
    record["phase_s"]["26 large images"] = record["large_images"]["phase_s"]

    # -- 27 defaults -----------------------------------------------------------
    record["defaults"] = default_scenes(dev, cam, reset_counts, read_counts)
    record["phase_s"]["27 defaults"] = record["defaults"]["phase_s"]

    # -- 28 the group table ----------------------------------------------------
    record["group_table"] = group_tables(dev, cam, reset_counts, read_counts)
    record["phase_s"]["28 group table"] = record["group_table"]["phase_s"]

    # -- result lines ---------------------------------------------------------
    record["main_path_launches"] = main_launches
    worst_err = max(r["max_abs_err"] for r in record["compare"] + [head])

    def worst(kernel, runs):
        return max(v["max_abs_err"] for r in runs if r["kernel"] == kernel
                   for v in r.values() if isinstance(v, dict))

    def segments(width, height, spp, bounces, rr):
        inputs = rk.regen_inputs(build_scene(1, device=dev), cam, width,
                                 height, spp)
        return float(rk.regen_kernel(*inputs, samples=spp, max_depth=bounces,
                                     rr_start=rr, emit_depth=True)
                     .double().sum())

    def scan_ops(width, height, spp, bounces, rr):
        """Operations of the two-level scans at these inputs (scene 1), as
        kernel 1's count mode measures them: a lane that scans runs its
        warp's slot tests of that scan (the large entries and GROUP an
        opened group), OPS_TEST_STAGED each, and every group's bound test,
        OPS_BOUND_TEST each. A warp's tests a scan are its tests over its
        issues; its lanes' scans are their segments."""
        inputs = rk.regen_inputs(build_scene(1, device=dev), cam, width,
                                 height, spp)
        seg, issues, _, tests = rk.regen_counts(
            *inputs, samples=spp, max_depth=bounces, rr_start=rr)
        lane_scans = seg.double().view(-1, 32).sum(1)
        slot_tests = float((tests.double() / issues.double().clamp_min(1)
                            * lane_scans).sum())
        groups = record["group_table"]["groups"]
        return (slot_tests * OPS_TEST_STAGED
                + float(lane_scans.sum()) * groups * OPS_BOUND_TEST)

    n1 = build_scene(1, device="cpu").num_slots
    scene_bytes = n1 * kio.USED_COLS * 4 + 96
    px_head = 1280 * 768
    px_small = 320 * 192
    # kernels 1 and 7 and kernel 2's park render scan in two levels (the
    # count mode's work); kernel 3's reverse and kernel 6 test every slot
    head_ops = scan_ops(1280, 768, 2, 25, None)
    regen_bound = bound(head_ops, px_head * 28 + scene_bytes)
    # the f64 kernel at the same shape: kernel 1's segments, every slot
    # tested (the f64 paths part from the f32 ones only at knife edges);
    # ids, ii and jj read, the image written (double for f64)
    f64_bound = bound(segments(1280, 768, 2, 25, None) * n1 * OPS_TEST_STAGED,
                      px_head * (12 + 24) + scene_bytes + 24 * 8, FP64_PER_S)
    compact_bound = bound(head_ops, px_head * (12 + 12) + scene_bytes)
    grad_bound = bound(segments(320, 192, 4, 8, 2) * n1 * OPS_TEST_STAGED,
                       px_small * 24 + scene_bytes + n1 * 64)
    fused_bound = bound(scan_ops(1280, 768, 2, 25, 2),
                        px_head * 36 + scene_bytes + n1 * 64)
    gt = record["group_table"]

    def kernel_row(name, source, replaces, max_abs_err, ms, plain_ms, bnd,
            library_ms=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": main_launches[name],
                "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "bound_fmad_off_ms": bnd[2],
                "library_ms": library_ms}

    kernels = {"kernels": [
        kernel_row("regen_render", KERNEL_SOURCE, KERNEL_REPLACES, worst_err,
            head["kernel_ms"], head["plain_ms"], regen_bound),
        kernel_row("grad_render", TRAIN_SOURCE, GRAD_REPLACES,
            worst("grad_render", record["grads"]), grad_main["kernel_ms"],
            grad_main["plain_ms"], grad_bound),
        kernel_row("fused_train_render", TRAIN_SOURCE, FUSED_REPLACES,
            worst("fused_train_render", record["grads"]),
            fused_head["kernel_ms"], fused_head["plain_ms"], fused_bound),
        kernel_row("stream_render", STREAM_SOURCE, STREAM_REPLACES,
            max(r["max_abs_err"] for r in record["stream_compare"]),
            render_100k["kernel_ms"], render_100k["plain_ms"],
            (render_100k["bound_ms"], render_100k["bound_by"],
             render_100k["bound_fmad_off_ms"])),
        kernel_row("stream_train", STREAM_TRAIN_SOURCE, STREAM_TRAIN_REPLACES,
            worst("stream_train", record["stream_grads"]),
            train_100k["kernel_ms"], train_100k["plain_ms"],
            (train_100k["bound_ms"], train_100k["bound_by"],
             train_100k["bound_fmad_off_ms"])),
        kernel_row("stream_segment_sum", STREAM_TRAIN_SOURCE, SEGMENT_REPLACES,
            segment_main["max_abs_err"], segment_main["kernel_ms"],
            segment_main["plain_ms"],
            (segment_main["bound_ms"], segment_main["bound_by"],
             segment_main["bound_fmad_off_ms"]),
            segment_main["library_ms"]),
        kernel_row("f64_render", F64_SOURCE, F64_REPLACES,
            max(r["max_abs_err"] for r in record["f64_compare"]),
            f64_head["kernel_ms"], f64_head["plain_ms"], f64_bound),
        kernel_row("compact_render", COMPACT_SOURCE, COMPACT_REPLACES,
            max(r["max_abs_err"] for r in record["compact_compare"]),
            compact_head["kernel_ms"], compact_head["plain_ms"],
            compact_bound),
        kernel_row("group_table", GROUP_TABLE_SOURCE, GROUP_TABLE_REPLACES,
            0.0, gt["kernel_ms"], gt["plain_ms"], gt["bound"]),
        kernel_row("walk_tables",
            "raytracingincuda_torch/csrc/staged_walk.cuh", "none: the "
            "port's own (the walk's tables: scan_table_kernel, before each "
            "kernel-4 and kernel-5 launch)", 0.0, tables_100k["kernel_ms"],
            tables_100k["plain_ms"], tables_100k["bound"]),
    ]}
    if min(k["launches"] for k in kernels["kernels"]) < 1:
        raise AssertionError(f"a kernel did not launch on the main path: "
                             f"{main_launches}")
    record["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(kernels))
    print(rec["name_power_limit"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
