#!/usr/bin/env python3
"""Kernel 1's two-level scan against its one-level scan as the scene grows:
where the group table pays for its shared memory.

    PYTHONPATH=. python3 probes/scan_range.py [--spheres 480 1000 1500 2000]
        [--samples 100] [--reps 3] [--tag X]

For each count of random spheres (``models.scene.build_random_scene``: the
reference's material mix and a ground sphere, slots padded to 128) in two
layouts, the ±50 patch the tests use and a patch of scene 1's density
(±11 sqrt(n / 481)), and for scene 1 itself: kernel 1 renders the
headline (1280x768, ``--samples`` samples, 25 bounces, parity, layout
'vmem') with the group table its launch builds and with none (the
one-level scan), in alternating pairs, ``--reps`` pairs after one warm-up
of each, timed with CUDA events; the two images must be the same bits.
Beside the times: the path the launch took, the dynamic shared memory a
block stages on each path, and the count mode's slot tests a warp
iteration (bound tests included) as a share of the slots. Prints one JSON
line a scene and writes them to ``chiprun_out/scan_range_<tag>.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
W, H, DEPTH = 1280, 768, 25
GATHER_BYTES = 16 + 7 * 4      # a staged slot: float4 scan entry, 7 gathers


def staged(n: int, groups: bool) -> int:
    """path_common.cuh:staged_bytes for layout 'vmem'."""
    from raytracingincuda_torch.ops import group_scan as gs

    base = n * GATHER_BYTES
    if not groups:
        return base
    return ((base + 15) & ~15) + gs.entries(n) * 20 + gs.bounds(n) * 16


def measure(name, scene, samples, reps):
    import torch

    from raytracingincuda_torch.models.camera import CameraConfig
    from raytracingincuda_torch.ops import group_scan as gs
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.utils import trace

    inputs = rk.regen_inputs(scene, CameraConfig.reference_default(), W, H,
                             samples)
    n = inputs[4].shape[0]
    kw = dict(samples=samples, max_depth=DEPTH, finalize_scale=1.0 / samples)
    real = gs.group_table

    def render(two: bool):
        gs.group_table = real if two else (lambda *args: None)
        try:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            img = rk.regen_kernel(*inputs, **kw)
            b.record()
            torch.cuda.synchronize()
            return img, a.elapsed_time(b)
        finally:
            gs.group_table = real

    before = trace.counts().get("scan.two_level", 0)
    two_img, _ = render(True)
    took_two = trace.counts().get("scan.two_level", 0) > before
    one_img, _ = render(False)
    if not torch.equal(two_img, one_img):
        raise AssertionError(f"{name}: the two paths' images differ")
    two_ms, one_ms = [], []
    for _ in range(reps):
        two_ms.append(render(True)[1])
        one_ms.append(render(False)[1])
    _, issues, _, tests = rk.regen_counts(*inputs, samples=samples,
                                          max_depth=DEPTH)
    groups = 0
    if took_two:
        groups = gs.unpack(gs.group_table_kernel(
            inputs[4][:, :rk.USED_COLS].t().contiguous(), inputs[5]),
            n).n_groups
    it = int(issues.long().sum())
    share = (int(tests.long().sum()) + it * groups) / it / n
    return {"scene": name, "slots": n, "two_level": took_two,
            "two_ms": two_ms, "one_ms": one_ms,
            "two_over_one": statistics.median(two_ms)
            / statistics.median(one_ms),
            "smem_two": staged(n, True), "smem_one": staged(n, False),
            "share_of_slots_tested": share, "groups": groups}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spheres", type=int, nargs="*",
                    default=[480, 1000, 1500, 2000])
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tag", default="probe")
    args = ap.parse_args()

    import torch

    from raytracingincuda_torch.models.scene import (build_random_scene,
                                                     build_scene)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    scenes = [("scene1", lambda: build_scene(1, device="cuda"))]
    for m in args.spheres:
        dense = 11.0 * math.sqrt(m / 481)
        scenes.append((f"random{m}_pm50",
                       lambda m=m: build_random_scene(m, device="cuda")))
        scenes.append((f"random{m}_pm{dense:.1f}",
                       lambda m=m, e=dense: build_random_scene(
                           m, half_extent=e, device="cuda")))
    lines = []
    for name, make in scenes:
        res = measure(name, make(), args.samples, args.reps)
        res["card"] = card.strip()
        print(json.dumps(res), flush=True)
        lines.append(res)
        torch.cuda.empty_cache()
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / f"scan_range_{args.tag}.json").write_text(
        json.dumps(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
