"""Inverse rendering demo: recover sphere albedos from a target image.

Because the tracer is differentiable (detached-sampler gradients,
``ops/grad.py``), scene parameters can be fitted to an image by gradient
descent: here the small-sphere albedos of scene 2 are found again from a
rendered target, starting from gray.

Run:  python -m raytracingincuda_torch.examples.inverse_rendering \
          [--steps 150] [--device cuda|cpu] \
          [--impl oracle|kernel|fused|stream] [--n_spheres N]

``--impl kernel`` renders with the regen kernel and differentiates with
the gradient kernel; ``--impl fused`` runs render, loss and gradients in
one launch of the fused kernel; ``--impl stream`` trains a streamed scene
through the stream kernels (``make_stream_train``), on a random scene of
``--n_spheres`` spheres when given (try 10000); ``--impl oracle`` is
autograd through the plain PyTorch tracer. On the CPU the kernels' plain
versions run.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=58)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=6)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--impl", choices=["oracle", "kernel", "fused", "stream"],
                    default="oracle")
    ap.add_argument("--n_spheres", type=int, default=0,
                    help="impl=stream: train on a random scene of this size "
                         "instead of scene 2")
    ap.add_argument("--loss", default="mse",
                    choices=["mse", "l1", "huber", "relmse"],
                    help="the fused steps' per-pixel loss (impl=fused or "
                         "stream)")
    ap.add_argument("--out", default="recovered.ppm")
    return ap


def run(args) -> list:
    """Fit and write the recovered image; returns the loss per step."""
    import torch

    from ..device import resolve_device
    from ..models.camera import CameraConfig
    from ..models.scene import (Scene, SceneParams, build_random_scene,
                                build_scene)
    from ..ops import grad as gradlib
    from ..ops import render_kernel as rk
    from ..ops import stream_kernel as sk
    from ..ops.vec import Vec3
    from ..utils.ppm import write_ppm

    if args.loss != "mse" and args.impl not in ("fused", "stream"):
        raise SystemExit(f"--loss {args.loss} needs impl=fused or stream "
                         "(the kernels' loss family)")
    dev = resolve_device(args.device)
    W, H = args.width, args.height
    stream = None
    if args.impl == "stream" and args.n_spheres:
        true_scene = build_random_scene(args.n_spheres, seed=3, device=dev)
    else:
        true_scene = build_scene(2, pad_to_multiple=64, device=dev)
    cam = CameraConfig.reference_default()

    def render(scene, gamma):
        if stream is None:
            return rk.render_kernel(scene, cam, W, H, args.samples,
                                    args.bounces, gamma=gamma)
        sm, bounds = sk.build_stream_arrays(scene, stream.perm, stream.block,
                                            stream.scene_mat.shape[0])
        return sk.render_stream(sk.StreamScene(sm, bounds, stream.block,
                                               stream.perm), cam, W, H,
                                args.samples, args.bounces, gamma=gamma)

    if args.impl == "stream":
        stream = sk.prepare_stream_scene(true_scene)
    print("rendering target...", file=sys.stderr)
    target = render(true_scene, False)

    gray = torch.full_like(true_scene.params.albedo.x, 0.5)
    init_params = true_scene.params._replace(albedo=Vec3(gray, gray, gray))
    trainable = SceneParams(center=Vec3(False, False, False), radius=False,
                            albedo=Vec3(True, True, True), fuzz=False,
                            ior=False)
    order = None
    if args.impl in ("kernel", "fused") and dev.type == "cuda":
        # a frozen difficulty order: speed only, never values
        probe_depth, probe_samples = min(8, args.bounces), min(6, args.samples)
        seg = rk.measure_difficulty(true_scene, cam, W, H, probe_depth,
                                    probe_samples)
        order = rk.difficulty_order(seg, probe_depth, probe_samples)
    if stream is not None:
        init_fn, step_fn = gradlib.make_stream_train(
            stream, W, H, args.samples, args.bounces, learning_rate=args.lr,
            trainable=trainable, loss=args.loss)
    else:
        extra = {"loss": args.loss} if args.impl == "fused" else {}
        init_fn, step_fn = gradlib.make_train_step(
            W, H, args.samples, args.bounces, learning_rate=args.lr,
            trainable=trainable, impl=args.impl, pixel_order=order, **extra)
    state = init_fn(init_params)
    losses = []
    for i in range(args.steps):
        state, loss = step_fn(state, cam, true_scene.mat_type,
                              true_scene.active, target)
        losses.append(float(loss))
        if i % 10 == 0 or i == args.steps - 1:
            err = float(torch.mean(
                (state.params.albedo.x - true_scene.params.albedo.x).abs()
                * true_scene.active))
            print(f"step {i:4d}  loss {losses[-1]:.6f}  albedo L1 {err:.4f}",
                  file=sys.stderr)
    img = render(Scene(state.params, true_scene.mat_type, true_scene.active),
                 True)
    write_ppm(args.out, img.cpu().double().numpy())
    print(f"wrote {args.out}", file=sys.stderr)
    return losses


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
