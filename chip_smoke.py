#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is
not 0; there is no CPU path):

  0 device   the card (nvidia-smi name and power limit), CUDA, driver
  1 build    nvcc builds the kernel from raytracingincuda_torch/csrc
  2 goldens  the kernel against the six committed goldens
  3 compare  the kernel against its plain PyTorch version on the card:
             scene 1 at 320x192x10spp/25b (parity and rr2, both scene
             layouts, the prepass segments, run-to-run bit identity),
             and at the headline's shapes (1280x768, 2 spp, 25b)
  4 headline make_renderer at scene 1, 1280x768, 100 spp, 25 bounces,
             parity and rr2: one warm-up and 3 timed renders each (CUDA
             events), the kernel's launch count over that run, and one
             render without the difficulty order
  5 cli      python -m raytracingincuda_torch.cli at 320x192x10spp

Then the kernels line (JSON), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Everything measured also goes to
chiprun_out/chip_smoke.json.
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
# kernel vs plain version on the card: share of quantized components and
# of prepass segments that must be equal
MIN_EXACT = 0.999


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's main path needs one", file=sys.stderr)
        return 2

    import numpy as np

    from raytracingincuda_torch.config import RenderConfig
    from raytracingincuda_torch.models.camera import CameraConfig
    from raytracingincuda_torch.models.scene import build_scene
    from raytracingincuda_torch.ops import _build
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.render_api import make_renderer
    from raytracingincuda_torch.utils import ppm
    from raytracingincuda_torch.utils.timing import RenderTimer, device_record

    dev = torch.device("cuda")
    record: dict = {}
    cam = CameraConfig.reference_default()

    # -- 0 device ------------------------------------------------------------
    rec = device_record()
    record["device"] = rec
    say("0 device", f"{rec['name_power_limit']} | torch {torch.__version__} "
        f"cuda {rec['torch_cuda']} | driver {rec['driver']} | "
        f"{rec['count']} device(s)")

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
    say("3 compare", f"prepass segments agree on {seg_agree:.6f}; "
        f"{head['shape']}: max|d| {head['max_abs_err']:.3g}, exact "
        f"{head['exact_quantized']:.6f}, kernel {head['kernel_ms']:.2f} ms, "
        f"plain {head['plain_ms']:.1f} ms")

    # -- 4 the main path at full width ----------------------------------------
    record["headline"] = {}
    launches = 0
    for rr in (None, 2):
        cfg = RenderConfig(scene_id=1, width=1280, height=768, samples=100,
                           bounces=25, rr_start=rr)
        renderer = make_renderer(cfg, dev)
        scene = build_scene(1, device=dev)
        rk.LAUNCHES = 0
        with RenderTimer(dev) as warm:
            img = renderer(scene, cam)          # prepass + render
        times = []
        for _ in range(3):
            with RenderTimer(dev) as t:
                img = renderer(scene, cam)
            times.append(t.ms)
        if rk.LAUNCHES < 4:
            raise AssertionError(f"{rk.LAUNCHES} kernel launches for 4 renders")
        launches += rk.LAUNCHES
        arr = img.cpu().numpy()
        if not (arr.shape == (768, 1280, 3) and np.isfinite(arr).all()
                and arr.min() >= 0.0 and arr.max() <= 1.0):
            raise AssertionError(f"headline image bad: {arr.shape}, "
                                 f"[{arr.min()}, {arr.max()}]")
        with RenderTimer(dev) as unsorted:
            rk.render_kernel(scene, cam, 1280, 768, 100, 25, rr_start=rr)
        best = min(times)
        name = "parity" if rr is None else f"rr{rr}"
        record["headline"][name] = {
            "render_ms": times, "warmup_with_prepass_ms": warm.ms,
            "unsorted_ms": unsorted.ms,
            "mrays_per_s": 1280 * 768 * 100 / best / 1e3,
            "vs_reference": REFERENCE_HEADLINE_MS / best,
        }
        say("4 headline", f"{name}: render_ms {', '.join(f'{t:.2f}' for t in times)}"
            f" | {1280 * 768 * 100 / best / 1e3:.1f} Mrays/s | "
            f"{REFERENCE_HEADLINE_MS / best:.3f}x the reference's "
            f"{REFERENCE_HEADLINE_MS} ms | warm-up with prepass "
            f"{warm.ms:.2f} ms | unsorted {unsorted.ms:.2f} ms")
    record["main_path_launches"] = launches

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

    # -- result lines ---------------------------------------------------------
    worst_err = max(r["max_abs_err"] for r in record["compare"] + [head])
    kernels = {"kernels": [{
        "name": "regen_render", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": worst_err, "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
    }]}
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
