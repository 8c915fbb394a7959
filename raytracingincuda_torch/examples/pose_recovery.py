"""Camera-pose recovery from a path-traced image.

The detached-sampler gradient (the production backward path) carries no
boundary terms, so pose descent on the raw path-traced MSE wanders. This
example runs the two-stage pipeline of ``ops/pose.py`` that fixes it:

  stage 1  recover_pose    Adam on the smoothed-visibility surrogate
                           (closed-form soft sphere silhouettes) under an
                           image pyramid: a wide capture basin; run for
                           --perturb >= 0.5.
  stage 2  refine_pose_fd  central finite differences on the real
                           path-traced MSE (deterministic renders, so a
                           noise-free objective whose differences include
                           the boundary terms), on the regen kernel.

Run:  python -m raytracingincuda_torch.examples.pose_recovery \\
          [--width 96 --height 58] [--device cuda|cpu]

On the CPU the kernel's plain version renders. Exit code 0 when the
recovered lookfrom is within 0.1 world units of the truth, else 1.
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=58)
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--bounces", type=int, default=8)
    ap.add_argument("--perturb", type=float, default=0.3,
                    help="initial lookfrom error, world units")
    ap.add_argument("--soft_steps", type=int, default=300,
                    help="stage-1 soft-surrogate steps (perturb >= 0.5)")
    ap.add_argument("--fd_steps", type=int, default=60,
                    help="stage-2 FD refinement steps")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    return ap


def run(args) -> float:
    """Recover the pose; returns the final lookfrom error."""
    import torch

    from ..device import resolve_device
    from ..models.camera import CameraConfig
    from ..models.scene import build_scene
    from ..ops import pose as poselib
    from ..ops.render_kernel import render_kernel

    dev = resolve_device(args.device)
    W, H = args.width, args.height
    scene = build_scene(2, device=dev)
    cam = CameraConfig.reference_default()
    true = poselib.pose_of(cam)

    def render(c):
        return render_kernel(scene, c, W, H, args.samples, args.bounces)

    print(f"target: path-traced {W}x{H}x{args.samples}spp/"
          f"d{args.bounces} at the true pose")
    target = render(cam)

    d = torch.tensor([0.71, -0.43, 0.56])
    d = args.perturb * d / torch.linalg.norm(d)
    init_cam = poselib.cam_with_pose(cam, true._replace(
        lookfrom=true.lookfrom + d,
        lookat=true.lookat + 0.3 * args.perturb
        * torch.tensor([-0.6, 0.45, 0.3])))

    def report(tag, ps):
        ef = float(torch.linalg.norm(ps.lookfrom - true.lookfrom))
        wt = true.lookfrom - true.lookat
        wr = ps.lookfrom - ps.lookat
        cos = torch.dot(wt, wr) / (torch.linalg.norm(wt)
                                   * torch.linalg.norm(wr))
        ang = float(torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0,
                                                           1.0))))
        mse = float(torch.mean(
            (render(poselib.cam_with_pose(cam, ps)) - target) ** 2))
        print(f"{tag}: lookfrom err {ef:.4f}  view-dir err {ang:.3f} deg  "
              f"path-traced MSE {mse:.6f}")
        return ef

    report("init     ", poselib.pose_of(init_cam))

    # The surrogate's edge objective is a coarse capture stage for large
    # pose errors; for moderate ones the FD stage alone converges and the
    # detour costs more than it brings.
    stage2_cam = init_cam
    if args.perturb >= 0.5:
        t0 = time.time()
        soft_pose, losses = poselib.recover_pose(
            scene, target, init_cam, W, H, steps=args.soft_steps,
            objective="edges")
        print(f"stage 1 (soft surrogate, edge objective, "
              f"{time.time() - t0:.0f}s): "
              f"loss {losses[0]:.5f} -> {losses[-1]:.6f}")
        report("stage 1  ", soft_pose)
        stage2_cam = poselib.cam_with_pose(cam, soft_pose)

    t0 = time.time()
    refined, hist = poselib.refine_pose_fd(
        scene, target, stage2_cam, W, H, samples_per_pixel=args.samples,
        max_depth=args.bounces, steps=args.fd_steps)
    print(f"stage 2 (FD on real MSE, {time.time() - t0:.0f}s): "
          f"MSE {hist[0]:.6f} -> {hist[-1]:.6f}")
    ef = report("recovered", refined)
    print("OK" if ef < 0.1 else "NOT CONVERGED")
    return ef


def main(argv=None) -> int:
    return 0 if run(build_parser().parse_args(argv)) < 0.1 else 1


if __name__ == "__main__":
    sys.exit(main())
