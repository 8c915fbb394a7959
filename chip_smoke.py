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
  6 grads    the gradient kernel against its plain version (scene 1,
             320x192x4spp/8b, parity and rr2, both layouts, run-to-run
             bit identity); the fused step kernel against its plain
             version (64x40x8spp/6b rr2, four losses, gamma on and off;
             its image bit-equal to the regen kernel's) and at the
             headline's shapes with 2 spp
  7 train    make_mse_train (the fused step) at scene 1, 1280x768,
             100 spp, 25 bounces, rr2, gamma, MSE, the difficulty order:
             one warm-up and 3 timed steps (CUDA events), finite
             gradients, the loss equal to the image's MSE
  8 trainer  the package's inverse-rendering example (20 Adam steps,
             impl fused) with a falling loss, then one make_train_step
             (impl kernel) step from gray albedos through make_diff_render

Then the kernels line (JSON), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Everything measured also goes to
chiprun_out/chip_smoke.json. Launch counts are set to 0 just before each
main path (phases 4, 7, 8) and read just after it.
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
    from raytracingincuda_torch.models.camera import (CameraConfig,
                                                      config_leaves)
    from raytracingincuda_torch.models.scene import build_scene, param_leaves
    from raytracingincuda_torch.ops import _build
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import train_kernel as tk
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
    grad_main = next(r for r in record["grads"] if r["kernel"] == "grad_render"
                     and r["rr_start"] == 2 and r["layout"] == "vmem")

    # -- 7 the train step at full width -------------------------------------
    width, height, spp, bounces = 1280, 768, 100, 25
    scene = build_scene(1, device=dev)
    rk.LAUNCHES = tk.GRAD_LAUNCHES = tk.FUSED_LAUNCHES = 0
    seg = rk.measure_difficulty(scene, cam, width, height, 8, 6)
    order = rk.difficulty_order(seg, 8, 6)
    gen = torch.Generator().manual_seed(0)
    target = torch.rand((height, width, 3), generator=gen).to(dev)
    step = tk.make_mse_train(scene.mat_type, scene.active, width, height, spp,
                             bounces, gamma=True, pixel_order=order, rr_start=2)
    with RenderTimer(dev) as warm:
        step(scene.params, cam, target)
    times = []
    for _ in range(3):
        with RenderTimer(dev) as t:
            loss_v, img, (d_params, d_cam) = step(scene.params, cam, target)
        times.append(t.ms)
    train_launches = {"regen_render": rk.LAUNCHES,
                      "fused_train_render": tk.FUSED_LAUNCHES,
                      "grad_render": tk.GRAD_LAUNCHES}
    if tk.FUSED_LAUNCHES < 4 or rk.LAUNCHES < 1:
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
    record["train"] = {
        "fused_train_step_ms": times, "warmup_ms": warm.ms,
        "loss": loss_f, "image_mse": mse, "vs_rr2_render": best / rr2_best,
        "launches": train_launches,
    }
    say("7 train", f"fused_train_step_ms {', '.join(f'{t:.2f}' for t in times)}"
        f" | {best / rr2_best:.3f}x the rr2 render ({rr2_best:.2f} ms) | "
        f"loss {loss_f:.6g} = image MSE {mse:.6g} | gradients finite | "
        f"warm-up {warm.ms:.2f} ms")

    # -- 8 the trainer --------------------------------------------------------
    from raytracingincuda_torch.examples import inverse_rendering
    from raytracingincuda_torch.models.scene import SceneParams
    from raytracingincuda_torch.ops import grad as gradlib
    from raytracingincuda_torch.ops.vec import Vec3

    rk.LAUNCHES = tk.GRAD_LAUNCHES = tk.FUSED_LAUNCHES = 0
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
    trainer_launches = {"regen_render": rk.LAUNCHES,
                        "fused_train_render": tk.FUSED_LAUNCHES,
                        "grad_render": tk.GRAD_LAUNCHES}
    record["trainer"] = {"losses": losses, "kernel_step_loss": float(k_loss),
                         "launches": trainer_launches}
    if not (losses[-1] < losses[0] and all(np.isfinite(losses))
            and tk.FUSED_LAUNCHES >= 20 and tk.GRAD_LAUNCHES >= 1
            and float(k_loss) > 0.0 and np.isfinite(float(k_loss))
            and all(bool(torch.isfinite(x).all())
                    for x in state.params.albedo)):
        raise AssertionError(f"trainer failed: {record['trainer']}")
    say("8 trainer", f"example impl=fused 20 steps: loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; make_train_step(impl='kernel') step loss "
        f"{float(k_loss):.6f}; launches {trainer_launches}")

    # -- result lines ---------------------------------------------------------
    worst_err = max(r["max_abs_err"] for r in record["compare"] + [head])
    main_launches = {
        "regen_render": launches + train_launches["regen_render"]
        + trainer_launches["regen_render"],
        "grad_render": train_launches["grad_render"]
        + trainer_launches["grad_render"],
        "fused_train_render": train_launches["fused_train_render"]
        + trainer_launches["fused_train_render"],
    }
    record["main_path_launches"] = main_launches

    def worst(kernel):
        return max(v["max_abs_err"] for r in record["grads"]
                   if r["kernel"] == kernel for v in r.values()
                   if isinstance(v, dict))

    kernels = {"kernels": [
        {"name": "regen_render", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES,
         "launches": main_launches["regen_render"], "max_abs_err": worst_err,
         "ms": head["kernel_ms"], "plain_ms": head["plain_ms"]},
        {"name": "grad_render", "route": "cuda", "source": TRAIN_SOURCE,
         "replaces": GRAD_REPLACES, "launches": main_launches["grad_render"],
         "max_abs_err": worst("grad_render"), "ms": grad_main["kernel_ms"],
         "plain_ms": grad_main["plain_ms"]},
        {"name": "fused_train_render", "route": "cuda", "source": TRAIN_SOURCE,
         "replaces": FUSED_REPLACES,
         "launches": main_launches["fused_train_render"],
         "max_abs_err": worst("fused_train_render"),
         "ms": fused_head["kernel_ms"], "plain_ms": fused_head["plain_ms"]},
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
