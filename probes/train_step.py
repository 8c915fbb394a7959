#!/usr/bin/env python3
"""Time the fused train step and the train kernels on one CUDA card, for
comparing trees of the port on the same card in one call.

    PYTHONPATH=<tree> python3 probes/train_step.py --tag NAME [--reps N]

The package is imported from ``PYTHONPATH``, so one call can time several
checkouts (parent, change, change, parent). It measures, at
``chip_smoke.py`` phase 7's cell (scene 1, 1280x768, 100 spp, 25 bounces,
rr2, gamma, MSE, the difficulty order): ``make_mse_train``'s step (a
warm-up, then ``--reps`` steps in CUDA events) and its peak memory; one
more step in a ``torch.profiler`` window (device time by kernel name, the
idle share); ``make_renderer``'s rr2 render at the same shape (3 renders),
for the step's share of it; kernel 2 (``fused_train_kernel``) at
1280x768x2spp/25b rr2 and kernel 3 (``grad_kernel``) at 320x192x4spp/8b
rr2 (3 launches each, after a warm-up); and one ``make_diff_render``
forward and backward (kernel 3 once) at 640x384x8spp/8b rr2, with the
backward timed alone. Where the tree has ``fused_train_parts``, the
park's plan and entries a lane at the step's cell. Prints one JSON line
and writes it to ``chiprun_out/train_step_<tag>.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch


def timed(fn, reps):
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


def profiled(step) -> dict:
    """Device ms by kernel name and the idle share of one step."""
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
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in events:
        by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                + (e.time_range.end - e.time_range.start) / 1e3)
    busy = sum(by_name.values())
    wall = start.elapsed_time(end)
    return {"wall_ms": wall, "device_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall) if busy else None,
            "device_ms_by_name": dict(sorted(by_name.items(),
                                             key=lambda kv: -kv[1])[:8])}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import raytracingincuda_torch
    from raytracingincuda_torch.config import RenderConfig
    from raytracingincuda_torch.models.camera import CameraConfig
    from raytracingincuda_torch.models.scene import (build_scene, param_leaves,
                                                      params_from_leaves)
    from raytracingincuda_torch.ops import kernel_io as kio
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import train_kernel as tk
    from raytracingincuda_torch.render_api import make_renderer
    from raytracingincuda_torch.utils.timing import RenderTimer

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    res = {"tag": args.tag, "card": card,
           "package": str(Path(raytracingincuda_torch.__file__).parent)}
    cam = CameraConfig.reference_default()
    w, h, spp, bounces = 1280, 768, 100, 25
    scene = build_scene(1, device=dev)
    seg = rk.measure_difficulty(scene, cam, w, h, 8, 6)
    order = rk.difficulty_order(seg, 8, 6)
    target = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(
        0)).to(dev)
    step = tk.make_mse_train(scene.mat_type, scene.active, w, h, spp, bounces,
                             gamma=True, pixel_order=order, rr_start=2)
    step(scene.params, cam, target)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.reps):
        with RenderTimer(dev) as t:
            step(scene.params, cam, target)
        times.append(t.ms)
    res["fused_step_ms"] = times
    res["fused_step_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    res["fused_step_profile"] = profiled(
        lambda: step(scene.params, cam, target))
    renderer = make_renderer(RenderConfig(scene_id=1, width=w, height=h,
                                          samples=spp, bounces=bounces,
                                          rr_start=2), dev)
    renderer(scene, cam)
    renders = []
    for _ in range(3):
        with RenderTimer(dev) as t:
            renderer(scene, cam)
        renders.append(t.ms)
    res["rr2_render_ms"] = renders
    res["step_over_render"] = min(times) / min(renders)
    if hasattr(tk, "fused_train_parts"):
        ids, ii, jj, _, sm, row = rk.regen_inputs(scene, cam, w, h, spp,
                                                  pixel_order=order)
        rows = kio.lane_rows(target, ids, w * h)
        parts = tk.fused_train_parts(ids, ii, jj, rows, sm, row, samples=spp,
                                     max_depth=bounces, rr_start=2,
                                     num_pixels=w * h)
        pk = parts.parked.double()
        res["park"] = {"capacity": parts.plan.capacity,
                       "windows": len(parts.plan.windows),
                       "acc_in_smem": parts.plan.acc_in_smem,
                       "entries_mean": float(pk[1, :w * h].mean()),
                       "entries_max": float(pk[1, :w * h].max()),
                       "samples_retraced_share": float(
                           1.0 - pk[0, :w * h].sum() / (spp * w * h))}
        del parts
    # kernel 2's row and kernel 3's row
    ids, ii, jj, _, sm, row = rk.regen_inputs(scene, cam, w, h, 2)
    tgt = torch.rand((3, ids.shape[0]), generator=torch.Generator()
                     .manual_seed(4)).to(dev)
    _, res["kernel2_ms"] = timed(lambda: tk.fused_train_kernel(
        ids, ii, jj, tgt, sm, row, samples=2, max_depth=25, rr_start=2,
        num_pixels=w * h, gamma=True, loss="mse"), 3)
    ids, ii, jj, _, sm, row = rk.regen_inputs(scene, cam, 320, 192, 4)
    g = (torch.randn((3, ids.shape[0]), generator=torch.Generator()
                     .manual_seed(3)) * 1e-4).to(dev)
    _, res["kernel3_ms"] = timed(lambda: tk.grad_kernel(
        ids, ii, jj, g, sm, row, samples=4, max_depth=8, rr_start=2), 3)
    # one make_diff_render forward and backward
    dw, dh = 640, 384
    f = rk.make_diff_render(scene.mat_type, scene.active, dw, dh, 8, 8,
                            rr_start=2)
    dtarget = torch.rand((dh, dw, 3), generator=torch.Generator()
                         .manual_seed(7)).to(dev)
    leaves = [x.detach().requires_grad_(True)
              for x in param_leaves(scene.params)]
    params = params_from_leaves(leaves)

    def diff_step():
        img = f(params, cam)
        loss = ((img - dtarget) ** 2).mean()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss.backward()
        end.record()
        return start, end

    diff_step()
    torch.cuda.synchronize()
    bwd = []
    for _ in range(3):
        with RenderTimer(dev) as t:
            start, end = diff_step()
        end.synchronize()
        bwd.append(start.elapsed_time(end))
        res.setdefault("diff_render_fwd_bwd_ms", []).append(t.ms)
    res["diff_render_bwd_ms"] = bwd
    line = json.dumps(res)
    print(line)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"train_step_{args.tag}.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
