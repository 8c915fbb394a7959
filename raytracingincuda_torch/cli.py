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
reference's double variants do: ``--impl kernel`` on the f64 kernel
(parity estimator, layout vmem or hbm, the scene built in float32 as
JAX's df64 path builds it), ``--impl oracle`` on the f64 oracle (any
``--rr_start``, ``--legacy_sky`` and layout, the scene and camera built
in float64 as JAX's CPU path builds them). ``--scene_file`` renders a
scene asset (``.npz`` or ``.csv``, ``models/io.py``) instead of a
built-in scene; the file name then says scene 0, as the JAX package's
does.
``--impl adaptive`` renders with per-pixel sample budgets
(``ops/adaptive.py``): ``--samples`` is the probe budget, ``--max_samples``
the per-pixel cap. ``--chunk_pixels`` sizes the oracle's pixel chunks.

Multiple devices: one process per device, launched by ``torchrun``, for
example ``torchrun --nproc_per_node 2 -m raytracingincuda_torch.cli
--devices 2 --scene_id 1`` (``--devices`` 0, the default, takes the
launched world; any other value must equal it). Each rank renders its
slice of the pixels (``parallel/mesh.py``); rank 0 prints the line and
writes the PPM, whose bytes are the single-process run's.
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
    p.add_argument("--scene_file", type=str, default=None,
                   help="render a scene asset (.npz or .csv, models/io.py) "
                        "instead of a built-in --scene_id")
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
                   help="float64 renders in double: on the f64 kernel "
                        "(parity estimator, layout vmem or hbm), or with "
                        "--impl oracle on the f64 oracle (any estimator)")
    p.add_argument("--layout", choices=["vmem", "hbm", "packed"],
                   default="vmem",
                   help="scene in shared memory (vmem, 'const'), read from "
                        "device memory (hbm, 'global'), or the texture-path "
                        "analog (packed, 'tex': the stream kernel)")
    p.add_argument("--impl", choices=["kernel", "stream", "adaptive",
                                      "oracle"],
                   default="kernel",
                   help="the CUDA regeneration kernel, the stream kernel "
                        "(culled sphere blocks, any scene size), adaptive "
                        "per-pixel sampling on them, or the plain PyTorch "
                        "tracer")
    p.add_argument("--max_samples", type=int, default=None,
                   help="impl=adaptive: per-pixel spp cap (default 4x "
                        "--samples); --samples is the probe budget")
    p.add_argument("--adaptive_tol", type=float, default=0.05,
                   help="impl=adaptive: target relative error per pixel")
    p.add_argument("--adaptive_rounds", type=int, default=1,
                   help="impl=adaptive: refine rounds (>1 estimates the "
                        "error again after each refine)")
    p.add_argument("--stream_block", type=int, default=256,
                   help="impl=stream: spheres per block (a minimum)")
    p.add_argument("--stream_lane_group", type=int, default=None,
                   help="TPU culling granularity; ignored by the kernel")
    p.add_argument("--pixels_per_lane", type=int, default=None,
                   help="TPU schedule hint; ignored by the kernel")
    p.add_argument("--chunk_pixels", type=int, default=None,
                   help="impl=oracle: rays a pixel chunk (default "
                        "max(threads^2 x 128, 1024))")
    p.add_argument("--devices", type=int, default=0,
                   help="ranks to shard over: 0 (default) takes the world "
                        "torchrun launched, 1 without a launcher; any other "
                        "value must equal it")
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
    if args.scene_id is None and args.scene_file is None:
        print("Error: --scene_id (or --scene_file) is required.",
              file=sys.stderr)
        build_parser().print_help()
        return 1

    import torch

    from .config import RenderConfig
    from .models.camera import CameraConfig
    from .models.scene import build_scene
    from .parallel import mesh as meshlib
    from .render_api import make_renderer
    from .utils.ppm import write_ppm
    from .utils.timing import RenderTimer

    cfg = RenderConfig(
        scene_id=args.scene_id if args.scene_id is not None else 0,
        width=args.width, height=args.height,
        samples=args.samples, bounces=args.bounces, threads=args.threads,
        dtype=args.dtype, layout=args.layout, impl=args.impl, seed=args.seed,
        legacy_sky=args.legacy_sky, rr_start=args.rr_start,
        max_samples=args.max_samples, adaptive_tol=args.adaptive_tol,
        adaptive_rounds=args.adaptive_rounds,
        pixels_per_lane=args.pixels_per_lane,
        stream_block=args.stream_block,
        stream_lane_group=args.stream_lane_group,
        chunk_pixels=args.chunk_pixels,
    )
    meshlib.maybe_initialize_distributed()
    sharded = meshlib.world_size() > 1
    device = (meshlib.rank_device(args.device) if sharded
              else torch.device(args.device))
    renderer = make_renderer(cfg, device, n_devices=args.devices)
    lead = not sharded or torch.distributed.get_rank() == 0
    # the f64 oracle takes its scene and camera in double, as JAX's CPU
    # path builds them; the f64 kernel packs an f32 scene, as JAX's df64
    # path does
    scene_dtype = (torch.float64 if cfg.dtype == "float64"
                   and cfg.impl == "oracle" else torch.float32)
    cam = CameraConfig.reference_default(dtype=scene_dtype)

    def make_scene():
        if args.scene_file is not None:
            from .models.io import load_scene

            return load_scene(args.scene_file, dtype=scene_dtype,
                              device=device)
        return build_scene(cfg.scene_id, seed=cfg.seed, dtype=scene_dtype,
                           device=device)

    if args.warmup:
        renderer(make_scene(), cam)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t_e2e0 = time.perf_counter()
    scene = make_scene()
    prepare = getattr(renderer, "prepare", None)
    if prepare is not None:
        prepare(scene)
    with RenderTimer(device) as timer:
        img = renderer(scene, cam)
    if lead:
        print(f"{timer.ms:15.8f}", end=",")

    if args.write_output and lead:
        write_ppm(os.path.join(args.outdir, cfg.output_filename()),
                  img.cpu().numpy())
    e2e_ms = (time.perf_counter() - t_e2e0) * 1e3
    if lead:
        print(f"{e2e_ms:15.8f}")
    if sharded:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
