"""Joint camera-pose and scene-parameter recovery (bundle-adjustment style).

Recovers both the camera pose and the small-sphere albedos of scene 2 from
one path-traced target, with the two estimators that each handle what the
other cannot:

  pose   central finite differences on the real MSE (boundary terms
         included; 12 renders for 6 dimensions, the ``ops/pose.py``
         mechanism), on the regen kernel;
  scene  the detached-sampler analytic gradients (interior terms),
         thousands of dimensions for one backward pass:
         ``grad.make_train_step(impl='kernel')``, the regen kernel forward
         and the gradient kernel backward.

The update is joint (one Adam step on each, every iteration, after a
pose-only warm-up), not alternated in blocks: many albedo steps at a wrong
pose absorb the pose error into the albedos, and the two then oscillate.

Run:  python -m raytracingincuda_torch.examples.joint_recovery \\
          [--iters 70] [--device cuda|cpu]

On the CPU the kernels' plain versions run. Exit code 0 when the pose is
within 0.05 world units, the image MSE below 5e-5 and the albedo error
below 0.9 of the start's, else 1.
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=58)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--bounces", type=int, default=6)
    ap.add_argument("--iters", type=int, default=70)
    ap.add_argument("--pose_warmup", type=int, default=15,
                    help="pose-only iterations before albedos unfreeze "
                         "(gray albedos don't corrupt the pose signal, "
                         "but a wrong pose corrupts the albedo fit)")
    ap.add_argument("--scene_steps", type=int, default=3,
                    help="analytic scene steps per joint iteration")
    ap.add_argument("--perturb", type=float, default=0.2)
    ap.add_argument("--fd_eps", type=float, default=2e-2)
    ap.add_argument("--pose_lr", type=float, default=2e-2)
    ap.add_argument("--scene_lr", type=float, default=2e-2)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    return ap


def run(args) -> bool:
    """Recover pose and albedos; returns whether it converged."""
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..models.camera import CameraConfig
    from ..models.scene import Scene, SceneParams, build_scene
    from ..ops import grad as gradlib
    from ..ops import pose as poselib
    from ..ops.render_kernel import render_kernel
    from ..ops.vec import Vec3

    dev = resolve_device(args.device)
    W, H, SPP, D = args.width, args.height, args.samples, args.bounces
    true_scene = build_scene(2, pad_to_multiple=64, device=dev)
    true_cam = CameraConfig.reference_default()
    true_pose = poselib.pose_of(true_cam)

    def render(p, cam):
        return render_kernel(Scene(p, true_scene.mat_type, true_scene.active),
                             cam, W, H, SPP, D, gamma=False)

    print("rendering target at the true pose/scene...", file=sys.stderr)
    # a linear-radiance target: the analytic step compares in linear space
    # (sqrt-gamma has an unbounded slope at black), so the shared target
    # and the FD objective live there too
    target = render(true_scene.params, true_cam)

    gray = torch.full_like(true_scene.params.albedo.x, 0.5)
    params = true_scene.params._replace(albedo=Vec3(gray, gray, gray))
    dirn = torch.tensor([0.71, -0.43, 0.56])
    dirn = args.perturb * dirn / torch.linalg.norm(dirn)
    x = torch.cat([true_pose.lookfrom + dirn,
                   true_pose.lookat + 0.3 * args.perturb
                   * torch.tensor([-0.6, 0.45, 0.3])])

    def cam_at(xv):
        return poselib.cam_with_pose(true_cam,
                                     poselib.PoseState(xv[:3], xv[3:]))

    def mse_at(xv, p):
        return float(torch.mean((render(p, cam_at(xv)) - target) ** 2))

    trainable = SceneParams(center=Vec3(False, False, False), radius=False,
                            albedo=Vec3(True, True, True), fuzz=False,
                            ior=False)
    init_fn, step_fn = gradlib.make_train_step(
        W, H, SPP, D, learning_rate=args.scene_lr, trainable=trainable,
        impl="kernel")
    state = init_fn(params)
    pose_opt = poselib.adam([x], args.pose_lr)

    def errs(xv, p):
        ef = float(torch.linalg.norm(xv[:3] - true_pose.lookfrom))
        ea = float(torch.mean((p.albedo.x - true_scene.params.albedo.x).abs()
                              * true_scene.active))
        return ef, ea

    ef, ea = errs(x, state.params)
    print(f"init    : pose err {ef:.4f}  albedo L1 {ea:.4f}", file=sys.stderr)

    t0 = time.time()
    loss = None
    for it in range(args.iters):
        # pose: central differences of the joint MSE at the current scene
        g = np.zeros(6, np.float32)
        for k in range(6):
            e = torch.zeros(6)
            e[k] = args.fd_eps
            g[k] = (mse_at(x + e, state.params)
                    - mse_at(x - e, state.params)) / (2 * args.fd_eps)
        x.grad = torch.from_numpy(g)
        pose_opt.step()

        # scene: analytic steps at the current pose (after the warm-up)
        if it >= args.pose_warmup:
            cam = cam_at(x.clone())
            for _ in range(args.scene_steps):
                state, loss = step_fn(state, cam, true_scene.mat_type,
                                      true_scene.active, target)

        if it % 10 == 9 or it == args.iters - 1:
            ef, ea = errs(x, state.params)
            cur = float(loss) if loss is not None else mse_at(x, state.params)
            print(f"iter {it:3d}: pose err {ef:.4f}  albedo L1 {ea:.4f}"
                  f"  loss {cur:.6f}  ({time.time() - t0:.0f}s)",
                  file=sys.stderr)

    ef, ea = errs(x, state.params)
    final_loss = mse_at(x, state.params)
    # success: the pose recovered, the image matched, the albedos moved
    # toward the truth (spheres covering no pixel are unobservable, so
    # the albedo error cannot reach zero at this resolution)
    ea0 = 0.2121
    ok = ef < 0.05 and final_loss < 5e-5 and ea < 0.9 * ea0
    print(f"final   : pose err {ef:.4f}  albedo L1 {ea:.4f} "
          f"(init {ea0})  image MSE {final_loss:.2e}", file=sys.stderr)
    print("OK" if ok else "NOT CONVERGED")
    return ok


def main(argv=None) -> int:
    return 0 if run(build_parser().parse_args(argv)) else 1


if __name__ == "__main__":
    sys.exit(main())
