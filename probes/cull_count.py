#!/usr/bin/env python3
"""Kernel 1's (or, with ``--f64``, kernel 6's) two-level scan at the
headline: the sphere tests a warp issues an iteration, against the
brute-force scan's one test a slot.

    PYTHONPATH=. python3 probes/cull_count.py [--rows 400] [--samples 4]
        [--group 8 16] [--rr N] [--f64] [--card] [--card-samples 100]
        [--tag X]

CPU estimate (always): the plain version's rays at the headline (scene 1,
1280x768, 25 bounces, ``--samples`` samples, parity or ``--rr``) on the
rows ``--rows``, wave by wave (a wave is one iteration of kernel 1's loop,
a warp 32 consecutive lanes of a row), through ``group_scan.model_scan``:
the kernel's scan in f32 on the table its launch builds
(``group_table_reference``), with its warps' votes. Per warp iteration:
the large entries, one bound test a group, and ``GROUP`` tests an opened
group; every slot matched ``hit_world``'s winner or the probe raises.

``--card`` adds the count mode on the card over the whole headline at
``--card-samples`` samples: its measured slot tests and issues per warp
(``render_kernel.regen_counts``), as tests a warp iteration (bound tests
included) and as a share of the 512 slots, and kernel 1's render time
(CUDA events, the median of three renders after one warm-up).

``--f64`` reads kernel 6 at the same headline (parity; ``--rr`` does not
apply): the CPU estimate from the f64 plain version's rays
(``f64_kernel.f64_wave_rays``) through ``model_scan`` in double on
``double_table``'s entries, each wave's winner checked against kernel 6's
brute-force double scan (``f64_kernel._hit``); with ``--card`` its count
mode (``f64_kernel.f64_counts``) and kernel 6's render time.

Each ``--group`` other than the source's ``GROUP`` runs in a copy of the
package under ``_local/cull_g<G>/`` with ``kGroup`` changed in
``csrc/path_common.cuh`` (its own build), in a subprocess. Prints one JSON
line per group size and writes them to ``chiprun_out/cull_<tag>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
W, H, DEPTH = 1280, 768, 25


def cpu_estimate(rows, samples, rr):
    import torch

    from raytracingincuda_torch.models.camera import CameraConfig, initialize
    from raytracingincuda_torch.models.scene import build_scene
    from raytracingincuda_torch.ops import group_scan as gs
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops.intersect import hit_world

    scene = build_scene(1, device="cpu")
    sm = rk.pack_scene_matrix(scene)
    cam = rk.pack_camera(initialize(CameraConfig.reference_default(), W, H))
    table = gs.unpack(gs.group_table_reference(sm, cam), sm.shape[0])
    ids = torch.cat([torch.arange(W, dtype=torch.int32) + r * W for r in rows])
    fi = (ids % W).float()
    fj = torch.div(ids, W, rounding_mode="floor").float()
    budget = torch.full(ids.shape, float(samples))
    tot = {"iterations": 0, "tests": 0, "opened": 0, "lane_segments": 0}

    def wave(o, d, active):
        res = gs.model_scan(table, o, d, active)
        want = hit_world(scene, o, d)
        a = active
        if not (torch.equal(res.hit[a], want.hit[a])
                and torch.equal(res.t[a], want.t[a])
                and torch.equal(res.idx[a][want.hit[a]],
                                want.idx[a][want.hit[a]])):
            raise AssertionError("the two-level model missed a winner")
        live = int(a.view(-1, gs.WARP).any(1).sum())
        tot["iterations"] += live
        tot["tests"] += int(res.tests.sum()) + live * table.n_groups
        tot["opened"] += int(res.opened.sum())
        tot["lane_segments"] += int(a.sum())

    rk.wave_rays(ids, fi, fj, budget, sm, cam, wave, samples=samples,
                 max_depth=DEPTH, rr_start=rr)
    per = tot["tests"] / tot["iterations"]
    return {"rows": rows, "samples": samples, "groups": table.n_groups,
            "large": table.large, "small": table.small,
            "warp_iterations": tot["iterations"],
            "tests_per_warp_iteration": per,
            "share_of_slots": per / sm.shape[0],
            "groups_opened_per_warp_iteration":
                tot["opened"] / tot["iterations"]}


def cpu_estimate_f64(rows, samples):
    import torch

    from raytracingincuda_torch.models.camera import CameraConfig
    from raytracingincuda_torch.models.scene import build_scene
    from raytracingincuda_torch.ops import f64_kernel as fk
    from raytracingincuda_torch.ops import group_scan as gs
    from raytracingincuda_torch.ops import render_kernel as rk

    sm = rk.pack_scene_matrix(build_scene(1, device="cpu"))
    row = fk.camera_row(CameraConfig.reference_default(), W, H, "cpu")
    n = sm.shape[0]
    table = gs.double_table(gs.unpack(gs.group_table_reference(
        sm, row.float()[None]), n), sm)
    cols = fk._columns(sm.double(), sm)
    ids = torch.cat([torch.arange(W, dtype=torch.int32) + r * W for r in rows])
    fi = (ids % W).float()
    fj = torch.div(ids, W, rounding_mode="floor").float()
    tot = {"iterations": 0, "tests": 0, "opened": 0}

    def wave(o, d, a):
        res = gs.model_scan(table, o, d, a)
        hit, t, idx = fk._hit(cols, o, d)
        on = a & hit
        if not (torch.equal(res.hit[a], hit[a]) and torch.equal(
                res.t[on], t[on]) and torch.equal(res.idx[on], idx[on])):
            raise AssertionError("the double model missed a winner")
        live = int(a.view(-1, gs.WARP).any(1).sum())
        tot["iterations"] += live
        tot["tests"] += int(res.tests.sum()) + live * table.n_groups
        tot["opened"] += int(res.opened.sum())

    fk.f64_wave_rays(ids, fi, fj, sm, row, wave, samples=samples,
                     max_depth=DEPTH)
    per = tot["tests"] / tot["iterations"]
    return {"rows": rows, "samples": samples, "groups": table.n_groups,
            "large": table.large, "small": table.small,
            "warp_iterations": tot["iterations"],
            "tests_per_warp_iteration": per, "share_of_slots": per / n,
            "groups_opened_per_warp_iteration":
                tot["opened"] / tot["iterations"]}


def card_measure_f64(samples):
    import torch

    from raytracingincuda_torch.models.camera import CameraConfig
    from raytracingincuda_torch.models.scene import build_scene
    from raytracingincuda_torch.ops import f64_kernel as fk
    from raytracingincuda_torch.ops import group_scan as gs
    from raytracingincuda_torch.ops import kernel_io as kio

    inputs = fk.f64_inputs(build_scene(1, device="cuda"),
                           CameraConfig.reference_default(), W, H)
    kw = dict(samples=samples, max_depth=DEPTH)
    _, issues, opened, tests = fk.f64_counts(*inputs, **kw)
    n = inputs[3].shape[0]
    table = gs.unpack(gs.group_table_kernel(
        kio.soa(inputs[3]), inputs[4].float()[None]), n)
    it = int(issues.long().sum())
    per = (int(tests.long().sum()) + it * table.n_groups) / it
    times = []
    for k in range(4):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fk.f64_kernel(*inputs, **kw)
        b.record()
        torch.cuda.synchronize()
        if k:
            times.append(a.elapsed_time(b))
    return {"card_samples": samples, "warp_iterations": it,
            "tests_per_warp_iteration": per, "share_of_slots": per / n,
            "groups_opened_per_warp_iteration": int(opened.long().sum()) / it,
            "render_ms": sorted(times)[1], "render_ms_all": times}


def card_measure(samples, rr):
    import torch

    from raytracingincuda_torch.models.camera import CameraConfig
    from raytracingincuda_torch.models.scene import build_scene
    from raytracingincuda_torch.ops import group_scan as gs
    from raytracingincuda_torch.ops import kernel_io as kio
    from raytracingincuda_torch.ops import render_kernel as rk

    scene = build_scene(1, device="cuda")
    inputs = rk.regen_inputs(scene, CameraConfig.reference_default(), W, H,
                             samples)
    kw = dict(samples=samples, max_depth=DEPTH, rr_start=rr)
    seg, issues, opened, tests = rk.regen_counts(*inputs, **kw)
    n = inputs[4].shape[0]
    table = gs.unpack(gs.group_table_kernel(
        kio.soa(inputs[4]), inputs[5]), n)
    it = int(issues.long().sum())
    per = (int(tests.long().sum()) + it * table.n_groups) / it
    times = []
    for k in range(4):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        rk.regen_kernel(*inputs, **kw, finalize_scale=1.0 / samples)
        b.record()
        torch.cuda.synchronize()
        if k:
            times.append(a.elapsed_time(b))
    return {"card_samples": samples, "warp_iterations": it,
            "tests_per_warp_iteration": per, "share_of_slots": per / n,
            "groups_opened_per_warp_iteration": int(opened.long().sum()) / it,
            "render_ms": sorted(times)[1], "render_ms_all": times}


def variant(group: int) -> Path:
    """A copy of the package with kGroup = group, under _local/."""
    dst = ROOT / "_local" / f"cull_g{group}"
    pkg = dst / "raytracingincuda_torch"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "raytracingincuda_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = pkg / "csrc" / "path_common.cuh"
    text, k = re.subn(r"constexpr int kGroup = \d+;",
                      f"constexpr int kGroup = {group};", src.read_text())
    assert k == 1
    src.write_text(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="*", default=[400])
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--group", type=int, nargs="*", default=[8, 16])
    ap.add_argument("--rr", type=int, default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--card-samples", type=int, default=100)
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    from raytracingincuda_torch.ops import group_scan as gs

    if args.one and args.f64:
        res = {"group": gs.GROUP, "kernel": "f64_render",
               "cpu": cpu_estimate_f64(args.rows, args.samples)}
        if args.card:
            res["card"] = card_measure_f64(args.card_samples)
    elif args.one:
        res = {"group": gs.GROUP, "rr_start": args.rr,
               "cpu": cpu_estimate(args.rows, args.samples, args.rr)}
        if args.card:
            res["card"] = card_measure(args.card_samples, args.rr)
    if args.one:
        print(json.dumps(res), flush=True)
        return 0
    lines = []
    for g in args.group:
        tree = ROOT if g == gs.GROUP else variant(g)
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one",
               "--rows", *map(str, args.rows), "--samples", str(args.samples),
               "--card-samples", str(args.card_samples)]
        cmd += ["--rr", str(args.rr)] if args.rr is not None else []
        cmd += ["--card"] if args.card else []
        cmd += ["--f64"] if args.f64 else []
        env = dict(os.environ, PYTHONPATH=str(tree))
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             cwd=ROOT)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(json.loads(line))
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / f"cull_{args.tag}.json").write_text(json.dumps(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
