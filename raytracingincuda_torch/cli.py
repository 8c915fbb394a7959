"""Command-line renderer: ``python -m raytracingincuda_torch.cli --scene_id 1``

The reference executables' interface: the same six flags, the same
output file name, and the same stdout line, ``render_ms,e2e_ms`` as two
fixed-point fields. ``render_ms`` is a CUDA-event bracket around the
render (a host-clock bracket on ``--device cpu``); ``e2e_ms`` runs from
scene construction to the written file. A warm-up render (the kernel
build and, where the renderer orders its lanes, the prepass and its
order cache) runs first unless ``--no-warmup``.

``--threads``, ``--pixels_per_lane`` and ``--stream_lane_group`` are
accepted for parity with the reference and the JAX package; they shaped
the TPU schedule and the CUDA kernels ignore them (one thread per pixel,
128-thread blocks). A renderer's ``prepare`` (the stream scene's Morton
sort and block bounds) runs after the scene is built and before the
render bracket, like the reference's upload. ``--dtype float64``
renders in double and writes the PPM from the double image, as the
reference's double variants do.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytrace-torch",
        description="Path tracer on PyTorch and CUDA (Hopper)",
    )
    p.add_argument("--scene_id", type=int, help="ID of the scene to render")
    p.add_argument("--width", type=int, default=320,
                   help="Width of the output image")
    p.add_argument("--height", type=int, default=192,
                   help="Height of the output image")
    p.add_argument("--samples", type=int, default=10,
                   help="Number of samples per pixel")
    p.add_argument("--bounces", type=int, default=25,
                   help="Maximum number of ray bounces")
    p.add_argument("--threads", type=int, default=8,
                   help="reference parity and file name; ignored by the "
                        "kernel")
    p.add_argument("--seed", type=int, default=1227)
    p.add_argument("--rr_start", type=int, default=None,
                   help="Russian-roulette start depth (default off = the "
                        "reference estimator)")
    p.add_argument("--legacy_sky", action="store_true",
                   help="shade the sky by the primary ray (the reference "
                        "CUDA variants' quirk)")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32",
                   help="float64 renders in double on the f64 kernel "
                        "(parity estimator, layout vmem or hbm)")
    p.add_argument("--layout", choices=["vmem", "hbm", "packed"],
                   default="vmem",
                   help="scene in shared memory (vmem, 'const'), read from "
                        "device memory (hbm, 'global'), or the texture-path "
                        "analog (packed, 'tex': the stream kernel)")
    p.add_argument("--impl", choices=["kernel", "stream", "oracle"],
                   default="kernel",
                   help="the CUDA regeneration kernel, the stream kernel "
                        "(culled sphere blocks, any scene size) or the "
                        "plain PyTorch tracer")
    p.add_argument("--stream_block", type=int, default=256,
                   help="impl=stream: spheres per block (a minimum)")
    p.add_argument("--stream_lane_group", type=int, default=None,
                   help="TPU culling granularity; ignored by the kernel")
    p.add_argument("--pixels_per_lane", type=int, default=None,
                   help="TPU schedule hint; ignored by the kernel")
    p.add_argument("--outdir", type=str, default=".")
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   help="time the first render (kernel build and prepass "
                        "included)")
    p.add_argument("--no-output", dest="write_output", action="store_false",
                   help="skip the PPM write")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.scene_id is None:
        print("Error: --scene_id is required.", file=sys.stderr)
        build_parser().print_help()
        return 1

    import torch

    from .config import RenderConfig
    from .models.camera import CameraConfig
    from .models.scene import build_scene
    from .render_api import make_renderer
    from .utils.ppm import write_ppm
    from .utils.timing import RenderTimer

    cfg = RenderConfig(
        scene_id=args.scene_id, width=args.width, height=args.height,
        samples=args.samples, bounces=args.bounces, threads=args.threads,
        dtype=args.dtype, layout=args.layout, impl=args.impl, seed=args.seed,
        legacy_sky=args.legacy_sky, rr_start=args.rr_start,
        pixels_per_lane=args.pixels_per_lane,
        stream_block=args.stream_block,
        stream_lane_group=args.stream_lane_group,
    )
    device = torch.device(args.device)
    renderer = make_renderer(cfg, device)
    cam = CameraConfig.reference_default()
    if args.warmup:
        renderer(build_scene(cfg.scene_id, seed=cfg.seed, device=device), cam)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t_e2e0 = time.perf_counter()
    scene = build_scene(cfg.scene_id, seed=cfg.seed, device=device)
    prepare = getattr(renderer, "prepare", None)
    if prepare is not None:
        prepare(scene)
    with RenderTimer(device) as timer:
        img = renderer(scene, cam)
    print(f"{timer.ms:15.8f}", end=",")

    if args.write_output:
        write_ppm(os.path.join(args.outdir, cfg.output_filename()),
                  img.cpu().numpy())
    e2e_ms = (time.perf_counter() - t_e2e0) * 1e3
    print(f"{e2e_ms:15.8f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
