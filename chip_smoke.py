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
             before it regenerated
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
             blocks tested per warp) beside the stream kernel's own union
             at the same shape; on the step's own stream (100k
             spheres, blocks of 256 front to back) at 640x384x1spp/3b,
             the stream kernel (bit for bit) and both modes of the stream
             train kernel against their plain versions
  13 stream scale  1M spheres: the block after _auto_block, one forward
             at 640x384x1spp/10b and one fused step at 1spp/6b, finite
             gradients, peak memory; the stream kernel and the fused mode
             against their plain versions on its blocks of 1024 at
             64x40x1spp/6b
  14 stream cli  the CLI with --impl stream and --layout packed at scene
             1, 320x192x10spp (the file names, images against the regen
             kernel's), and the example with --impl stream --n_spheres
             2000 --steps 20 (a falling loss)
  15 f64 compare  the f64 kernel against its plain version, bit for bit
             and from run to run: scene 1 at 320x192x4spp/8b (both
             layouts) and at the headline's width (1280x768, 2 spp, 25b)
  16 f64 headline  make_renderer(dtype='float64') at scene 1, 1280x768,
             100 spp, 25 bounces, parity, vmem, the f32 difficulty order:
             one warm-up and 3 timed renders, launches, and the image's
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
             kernel unsorted, the images bit-equal; one mode='simple'
             render at the headline (kernel 1's launches) equal to them

Then the kernels line (JSON, with each kernel's bound and, as
bound_fmad_off_ms, the same bound with the operations at half the rate,
since --fmad=false issues each multiply and add alone: regen_render,
grad_render, fused_train_render, stream_render, stream_train,
stream_segment_sum, f64_render and compact_render), the nvidia-smi line,
and last {"ok": true, "device": {...}}. Everything measured is
also written to chip_smoke.json in the output directory. Launch counts
are set to 0 just before each main path (phases 4, 7, 8, 10, 12, 13, 14,
16, 17) and read just after it: each path's own counts are in chip_smoke.json
(launches_by_phase) and their sums are the kernels line's launches.
fused_train_render counts its two launches a window (the park render,
then the reverse; one window at the headline), grad_render its reverse,
one a window; stream_segment_sum counts its two kernels (tile_sums_kernel,
then cross_sums_kernel), two per call; stream_train counts walk_counts'
launch too (outside the main paths); stream_scan_table (no row of its own)
counts the scan-table kernel that runs before each launch of kernels 4
and 5. The stream rows' times and bounds
are those of the 100k comparisons in phase 12; the f64 and compact rows'
those of the headline-width comparisons in phases 15 and 17.
"""
from __future__ import annotations

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
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import stream_kernel as sk
    from raytracingincuda_torch.ops import stream_train_kernel as stk
    from raytracingincuda_torch.ops import train_kernel as tk
    from raytracingincuda_torch.render_api import make_renderer
    from raytracingincuda_torch.utils import ppm
    from raytracingincuda_torch.utils.timing import RenderTimer, device_record

    global CARD
    dev = torch.device("cuda")
    record: dict = {}
    cam = CameraConfig.reference_default()
    counters = {"stream_scan_table": (sk, "SCAN_LAUNCHES"),
                "regen_render": (rk, "LAUNCHES"),
                "grad_render": (tk, "GRAD_LAUNCHES"),
                "fused_train_render": (tk, "FUSED_LAUNCHES"),
                "stream_render": (sk, "LAUNCHES"),
                "stream_train": (stk, "LAUNCHES"),
                "stream_segment_sum": (stk, "SEGMENT_LAUNCHES"),
                "f64_render": (fk, "LAUNCHES"),
                "compact_render": (ck, "LAUNCHES")}
    main_launches = {name: 0 for name in counters}
    record["launches_by_phase"] = {}

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts(path: str) -> dict:
        """The counts since the last reset, kept under this main path's
        name and added to the kernels line's sums."""
        got = {name: getattr(mod, attr)
               for name, (mod, attr) in counters.items()}
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
    def timed(fn, reps, warm=True):
        if warm:
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / reps

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
        seg, issues = rk.regen_counts(*inputs, samples=spp, max_depth=bounces,
                                      rr_start=rr)
        mean = float(seg.double().view(-1, 32).mean(1).sum())
        nested = float(rk.warp_iterations(per, "nested").sum())
        out = {"warp_issues": int(issues.long().sum()),
               "lane_mean_segments": mean,
               "issues_over_mean": float(issues.double().sum()) / mean,
               "nested_iterations": nested, "nested_over_mean": nested / mean}
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
        if read_counts("4 headline " + ("parity" if rr is None else
                                        f"rr{rr}"))["regen_render"] < 4:
            raise AssertionError(f"{rk.LAUNCHES} kernel launches for 4 renders")
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
    def grad_compare(kernel_out, plain_out, names):
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
                 + 4 * n * tk.GRAD_COLS * 4)
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
    if tk.FUSED_LAUNCHES < 8 or rk.LAUNCHES < 1:
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
        ids, ii, jj, tk._lane_rows(target, ids, width * height), sm, row,
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
            and tk.FUSED_LAUNCHES >= 40 and tk.GRAD_LAUNCHES >= 1
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
        ids, ii, jj, bud = rk._lane_setup(width, height, None, spp, 0, None,
                                          dev)
        row = rk.pack_camera(initialize(cam, width, height)).to(dev)
        return ids, ii, jj, bud, row

    def walk_stats(st, width, height, spp, bounces, rr):
        """(traced segments, opened blocks, blocks the warps tested) of the
        walk at these inputs, from the kernel's own counts."""
        ids, ii, jj, bud, row = lanes(width, height, spp)
        c = sk.stream_kernel(ids, ii, jj, bud, st.scene_mat, st.bounds, row,
                             block=st.block, samples=spp, max_depth=bounces,
                             rr_start=rr, emit_stats=True).double().sum(1)
        return float(c[0]), float(c[1]), float(c[2])

    def walk_ops(st, segs, opened):
        return (segs * st.bounds.shape[0] + opened * st.block) * OPS_TEST_STAGED

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
        segs, opened, fetched = (float(v) for v in k_stats.double().sum(1))
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
               "kernel_ms": k_ms, "plain_ms": p_ms}
        res["bound_ms"], res["bound_by"], res["bound_fmad_off_ms"] = bound(
            walk_ops(st, segs, opened),
            padded * 28 + st.scene_mat.shape[0] * rk.USED_COLS * 4
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
    with RenderTimer(dev) as brute:
        rk.render_kernel(s100k, cam, w, h, 2, 10, layout="hbm")
    st_head = sk.reorder_front_to_back(sk.prepare_stream_scene(s100k),
                                       initialize(cam, w, h).center)
    segs, opened, fetched = walk_stats(st_head, w, h, 10, 10, None)
    head_bound = bound(walk_ops(st_head, segs, opened), 0)[0]
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
        segs, opened, _ = walk_stats(st, width, height, spp, bounces, rr)
        padded = lanes(width, height, spp)[0].shape[0]
        return bound(walk_ops(st, segs, opened),
                     padded * 36 + st.scene_mat.shape[0]
                     * (rk.USED_COLS + 16) * 4 + st.bounds.numel() * 4 + 192)

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
    segs, opened, k4_fetched = walk_stats(st0, w, h, spp, bounces, None)
    step_bound = bound(walk_ops(st0, segs, opened), 0)[0]
    # the warp union of the step's walk: blocks tested per warp against the
    # blocks each lane opened (kernel 4's count)
    ids, ii, jj, _, row = lanes(w, h, spp)
    lane_open, warp_tested = stk.walk_counts(
        ids, ii, jj, st0.scene_mat, st0.bounds, row, block=st0.block,
        samples=spp, max_depth=bounces)
    union = {"opened_per_lane": int(lane_open.long().sum()),
             "tested_per_warp": int(warp_tested.long().sum())}
    union["lane_tests_over_opened"] = (32 * union["tested_per_warp"]
                                       / max(union["opened_per_lane"], 1))
    union["stream_kernel_tested_per_warp"] = int(k4_fetched)
    union["stream_kernel_lane_tests_over_opened"] = 32 * k4_fetched / opened
    if union["opened_per_lane"] != int(opened):
        raise AssertionError(f"kernel 5's walk opened {union} blocks, the "
                             f"stream kernel's {opened}")
    # the scatter's kernels on this step's records
    rows = tk._lane_rows(target, ids, w * h)
    _, rec_row, rec_val, _, _ = stk.train_records(
        ids, ii, jj, rows, st0.scene_mat, st0.bounds, row, block=st0.block,
        samples=spp, max_depth=bounces, seed=DEFAULT_SEED, rr_start=None,
        sample_offset=0, fused=True, num_pixels=w * h)
    (keys, src), order_ms = timed(lambda: stk.record_order(rec_row), 5)
    n_rows = st0.scene_mat.shape[0]
    seg_out, seg_ms = timed(lambda: stk.segment_sum_kernel(keys, src, rec_val,
                                                           n_rows), 5)
    seg_plain, seg_plain_ms = timed(lambda: stk.segment_sum_reference(
        keys, src, rec_val, n_rows), 1, warm=False)
    lib_keys, lib_vals = keys.long(), rec_val[src]
    lib_out = torch.zeros((n_rows, tk.GRAD_COLS), device=dev)
    _, lib_ms = timed(lambda: lib_out.zero_().index_add_(0, lib_keys,
                                                         lib_vals), 5)
    m = keys.shape[0]
    seg_bound, seg_by, seg_fmad_off = bound(m * tk.GRAD_COLS,
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
                                      tk._lane_rows(target, ids, w * h),
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

    def f64_compare(width, height, spp, bounces, layout, reps, plain=None):
        inputs = fk.f64_inputs(build_scene(1, device=dev), cam, width, height)
        kw = dict(samples=spp, max_depth=bounces, layout=layout)
        res, _, plain = bit_compare(lambda: fk.f64_kernel(*inputs, **kw),
                                    lambda: fk.f64_reference(*inputs, **kw),
                                    reps, plain)
        res.update(shape=f"{width}x{height}x{spp}spp/{bounces}b",
                   layout=layout)
        record["f64_compare"].append(res)
        say("15 f64 compare", f"{res['shape']} {layout}: bit-equal to plain, "
            f"run-to-run identical; kernel {res['kernel_ms']:.3f} ms, plain "
            f"{res['plain_ms']:.1f} ms")
        return res, plain

    record["f64_compare"] = []
    plain = None
    for layout in ("vmem", "hbm"):
        _, plain = f64_compare(320, 192, 4, 8, layout, 5, plain)
    f64_head, _ = f64_compare(1280, 768, 2, 25, "vmem", 3)
    del plain

    # -- 16 the f64 render at full width -------------------------------------
    cfg = RenderConfig(scene_id=1, width=1280, height=768, samples=100,
                       bounces=25, dtype="float64")
    renderer = make_renderer(cfg, dev)
    scene = build_scene(1, device=dev)
    reset_counts()
    with RenderTimer(dev) as warm:
        img64 = renderer(scene, cam)            # f32 prepass + render
    times = []
    for _ in range(3):
        with RenderTimer(dev) as t:
            img64 = renderer(scene, cam)
        times.append(t.ms)
    f64_counts = read_counts("16 f64 headline")
    arr = img64.cpu().numpy()
    if not (f64_counts["f64_render"] >= 4 and f64_counts["regen_render"] >= 1
            and img64.dtype == torch.float64 and arr.shape == (768, 1280, 3)
            and np.isfinite(arr).all() and arr.min() >= 0.0
            and arr.max() <= 1.0):
        raise AssertionError(f"f64 headline: {f64_counts}, {img64.dtype}, "
                             f"{arr.shape}, [{arr.min()}, {arr.max()}]")
    levels = np.abs(ppm.quantize(arr) - ppm.quantize(
        f32_headline.cpu().numpy()))
    best = min(times)
    record["f64_headline"] = {
        "render_ms": times, "warmup_with_prepass_ms": warm.ms,
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
    record["compact_headline"] = {
        "render_ms": times, "warmup_ms": warm.ms, "launches": compact_counts,
        "regen_unsorted_ms": regen_times, "simple_launches": simple_counts,
        "vs_regen_unsorted": min(times) / min(regen_times)}
    say("17 compact", f"headline render_kernel(mode='compact') render_ms "
        f"{', '.join(f'{t:.2f}' for t in times)} (warm-up {warm.ms:.2f}) "
        f"beside the regen kernel unsorted "
        f"{', '.join(f'{t:.2f}' for t in regen_times)}: "
        f"{min(times) / min(regen_times):.3f}x; images bit-equal, and "
        f"mode='simple' too; launches compact {nonzero(compact_counts)}, "
        f"simple {nonzero(simple_counts)}")
    del img_c, img_r, img_s

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

    n1 = build_scene(1).num_slots
    scene_bytes = n1 * rk.USED_COLS * 4 + 96
    px_head = 1280 * 768
    px_small = 320 * 192
    head_tests = segments(1280, 768, 2, 25, None) * n1
    regen_bound = bound(head_tests * OPS_TEST_STAGED,
                        px_head * 28 + scene_bytes)
    # the f64 and compact kernels at the same shape: kernel 1's count of
    # sphere tests (the f64 paths part from the f32 ones only at knife
    # edges); ids, ii and jj read, the image written (double for f64)
    f64_bound = bound(head_tests * OPS_TEST_STAGED,
                      px_head * (12 + 24) + scene_bytes + 24 * 8, FP64_PER_S)
    compact_bound = bound(head_tests * OPS_TEST_STAGED,
                          px_head * (12 + 12) + scene_bytes)
    grad_bound = bound(segments(320, 192, 4, 8, 2) * n1 * OPS_TEST_STAGED,
                       px_small * 24 + scene_bytes + n1 * 64)
    fused_bound = bound(segments(1280, 768, 2, 25, 2) * n1 * OPS_TEST_STAGED,
                        px_head * 36 + scene_bytes + n1 * 64)

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
