"""Camera-pose recovery: an edge-aware smoothed-visibility surrogate.

The counterpart of ``raytracingincuda_tpu/ops/pose.py``. The production
gradient estimator (``ops/grad.py``, the gradient kernels) follows the
detached-sampler convention: which sphere wins the closest hit, and hit
against miss, are constants of the tangent trace. Those gradients are
exact for interior shading terms but carry no boundary term: a pixel
whose content changes because an edge sweeps across it under camera
motion contributes no gradient, and a pose objective is dominated by
such edge terms, so descent on the path-traced MSE wanders.

Smooth visibility fixes that (soft rasterization, Liu et al. 2019;
edge-sampling and reparameterized integrators, Li et al. 2018 and Loubet
et al. 2019). For spheres it is closed-form: a silhouette is a circle, so
the signed distance of a ray to it is ``r - b``, with ``b`` the ray's
distance from the centre, and a sigmoid of it is a visibility with
exactly the boundary derivative the detached estimator lacks.

``soft_render`` is a deterministic first-hit shader (one centre ray a
pixel, no RNG): per-sphere soft visibility times a soft depth order (a
softmin over closest-approach depth), Lambert-like shading and the sky.
It is not the path-traced estimator but the smooth surrogate objective
for pose, differentiated by autograd through ``camera.initialize``. The
pipeline has two stages:

1. ``recover_pose``: Adam on the surrogate under an image pyramid (both
   sides pooled alike: pooling is linear, so the true pose stays the
   minimum while the basin widens). Against a soft target
   (``objective="mse"``) it converges from pose errors of 0.7 world units
   and more; against a real path-traced target (``objective="edges"``) it
   is a coarse capture stage for large errors.
2. ``refine_pose_fd``: central finite differences on the real path-traced
   MSE. Renders are deterministic (counter-based RNG), so the objective
   is free of noise and its differences include the boundary terms; the
   6 pose dimensions take 12 renders a step, on the regen kernel on the
   card by default.

Scope notes: the surrogate ignores defocus blur and secondary bounces
(reflections and refraction move with pose too; their edge terms are not
modelled, and at these scenes' scale the first-hit term dominates).
Dielectric spheres shade as glass grey. These are approximations of the
surrogate, not claims about the estimator. ``soft_render`` builds (N + 1,
R) tensors for N slots and R pixels: keep it at recovery resolutions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.camera import CameraConfig, initialize
from ..models.scene import DIELECTRIC, Scene
from . import f32math, vec
from .tracer import SKY_BLUE, SKY_WHITE
from .vec import Vec3

# Background pseudo-depth for the soft depth order: beyond every sphere's
# closest approach in the book scenes (the camera is about 25 units out).
T_BG = 60.0


class SoftConfig(NamedTuple):
    """Smoothness knobs, in the scene's world units.

    tau: angular silhouette softness: the sigmoid's band around the
         silhouette circle is ``tau * depth`` world units, about constant
         in pixels. A band proportional to the radius fails here: the
         r=1000 ground sphere would get a 50-unit band, still half
         visible at the horizon where rays cross behind the camera.
         Visibility behind the camera is closed by a smooth depth gate (a
         sigmoid over depth, about 0.1 units wide).
    lam: temperature of the softmin over closest-approach depth (world
         units); smaller means harder occlusion.
    """

    tau: float = 0.02
    lam: float = 0.15


def _primary_dirs(cam_cfg: CameraConfig, img_width: int, img_height: int):
    """Centre-of-pixel primary rays (no jitter, no defocus): (origin,
    direction) Vec3s of (R,) tensors on the camera config's device."""
    if img_width * img_height >= 2 ** 24:
        # f32 pixel ids lose integers from 2^24 on
        raise ValueError(f"soft_render supports < 2^24 pixels; got "
                         f"{img_width}x{img_height}")
    cam = initialize(cam_cfg, img_width, img_height)
    ids = torch.arange(img_width * img_height, dtype=torch.float32,
                       device=cam.center.x.device)
    fi = torch.remainder(ids, float(img_width))
    fj = torch.floor(ids / float(img_width))
    pixel = cam.pixel00_loc + cam.pixel_delta_u * fi + cam.pixel_delta_v * fj
    origin = Vec3(*(c.expand(fi.shape) for c in cam.center))
    return origin, pixel - origin


def soft_render(scene: Scene, cam_cfg: CameraConfig, img_width: int,
                img_height: int, cfg: SoftConfig = SoftConfig()
                ) -> torch.Tensor:
    """Smoothed-visibility first-hit render, (H, W, 3) in [0, 1] on the
    scene's device; differentiable in the camera config and the scene
    parameters, with silhouette (boundary) gradients."""
    dev = scene.mat_type.device
    o, d = _primary_dirs(cam_cfg, img_width, img_height)
    o = Vec3(*(c.to(dev) for c in o))
    dhat = vec.unit(Vec3(*(c.to(dev) for c in d)))

    p = scene.params
    # spheres along dim 0 (N, 1), rays along dim 1 (1, R)
    cx, cy, cz = p.center.x[:, None], p.center.y[:, None], p.center.z[:, None]
    r = vec.safe_radius(p.radius.abs())[:, None]
    active = scene.active.bool()[:, None]

    ocx = cx - o.x[None, :]
    ocy = cy - o.y[None, :]
    ocz = cz - o.z[None, :]
    # depth of the closest approach along the unit ray
    proj = (ocx * dhat.x[None, :] + ocy * dhat.y[None, :]
            + ocz * dhat.z[None, :])                              # (N, R)
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    b2 = vec.maximum(oc2 - proj * proj, 0.0)
    b = f32math.sqrt(b2 + 1e-12)  # the ray's distance from the centre

    # signed silhouette distance in units of the band: > 0 inside the
    # circle; its derivative through b is the boundary term
    band = cfg.tau * vec.maximum(proj, 1.0)
    sdf = (r - b) / band
    logit_vis = torch.nn.functional.logsigmoid(sdf)
    # spheres behind or at the camera fade out smoothly: a sigmoid gate
    # over depth, about 0.1 world units wide, closed by proj <= 0
    logit_vis = logit_vis + torch.nn.functional.logsigmoid(
        (proj - 0.1) * 50.0)
    logits = torch.where(active, logit_vis - proj / cfg.lam,
                         torch.full_like(proj, -1e30))            # (N, R)
    bg_logit = torch.full((1, logits.shape[1]), -T_BG / cfg.lam,
                          dtype=logits.dtype, device=dev)
    w = torch.softmax(torch.cat([logits, bg_logit], dim=0), dim=0)

    # per-sphere shading: Lambert against a fixed key light plus ambient,
    # at the normal of the (smoothed) first root
    thick = f32math.sqrt(vec.maximum(r * r - b2, 0.0) + 1e-12)
    t_surf = proj - thick
    nx = (o.x[None, :] + t_surf * dhat.x[None, :] - cx) / r
    ny = (o.y[None, :] + t_surf * dhat.y[None, :] - cy) / r
    nz = (o.z[None, :] + t_surf * dhat.z[None, :] - cz) / r
    lx, ly, lz = 0.4082483, 0.8164966, 0.4082483  # unit key light
    lambert = vec.clip(nx * lx + ny * ly + nz * lz, 0.0, 1.0)
    shade = 0.35 + 0.65 * lambert                                 # (N, R)
    glass = (scene.mat_type == DIELECTRIC)[:, None]
    albedo = [torch.where(glass, 0.9, a[:, None]) * shade for a in p.albedo]

    a = 0.5 * (dhat.y + 1.0)
    sky = [(1.0 - a) * wht + a * blu for wht, blu in zip(SKY_WHITE, SKY_BLUE)]

    w_s, w_bg = w[:-1], w[-1]
    img = [torch.sum(w_s * alb, dim=0) + w_bg * s
           for alb, s in zip(albedo, sky)]
    return torch.stack(img, dim=-1).reshape(img_height, img_width, 3)


class PoseState(NamedTuple):
    lookfrom: torch.Tensor  # (3,)
    lookat: torch.Tensor    # (3,)


def cam_with_pose(base: CameraConfig, pose: PoseState) -> CameraConfig:
    """``base`` with the pose's lookfrom and lookat."""
    return base._replace(
        lookfrom=Vec3(pose.lookfrom[0], pose.lookfrom[1], pose.lookfrom[2]),
        lookat=Vec3(pose.lookat[0], pose.lookat[1], pose.lookat[2]))


def pose_of(cam_cfg: CameraConfig) -> PoseState:
    lf, la = cam_cfg.lookfrom, cam_cfg.lookat
    return PoseState(torch.stack([lf.x, lf.y, lf.z]).to(torch.float32),
                     torch.stack([la.x, la.y, la.z]).to(torch.float32))


def _avg_pool(img: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pooling of (H, W, C) (the ragged edge cropped)."""
    if k == 1:
        return img
    h, w, c = img.shape
    h2, w2 = (h // k) * k, (w // k) * k
    return img[:h2, :w2].reshape(h2 // k, k, w2 // k, k, c).mean((1, 3))


def adam(tensors, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s counterpart: torch's Adam with optax's
    defaults (betas 0.9 / 0.999, eps 1e-8)."""
    return torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def recover_pose(scene: Scene, target: torch.Tensor, init_cam: CameraConfig,
                 img_width: int, img_height: int, *, steps: int = 300,
                 lr: float = 3e-2, soft: SoftConfig = SoftConfig(),
                 pyramid: tuple = (4, 2, 1), optimize_lookat: bool = True,
                 objective: str = "mse"):
    """Camera-pose recovery by gradient descent on the surrogate against
    an (H, W, 3) target, on the scene's device.

    With a ``soft_render`` target use ``objective="mse"``. With a real
    path-traced target use ``objective="edges"``: the surrogate's shading
    differs from the path tracer's (no reflections or shadows), so the
    photometric MSE has its minimum off the true pose; the squared
    differences of image-gradient maps of the gamma-mapped surrogate and
    the target keep the silhouette signal the two renderers share.

    The candidate renders at one fixed ``tau``, the target's: a blurrier
    candidate would score better by shrinking objects. The pyramid pools
    both images alike instead, a new Adam at each level with half the
    previous learning rate. Returns (PoseState, loss history)."""
    if objective not in ("mse", "edges"):
        raise ValueError(f"objective must be 'mse' or 'edges': {objective}")
    start = pose_of(init_cam)
    lf = start.lookfrom.detach().clone().requires_grad_(True)
    la = start.lookat.detach().clone().requires_grad_(True)
    target = torch.as_tensor(target, dtype=torch.float32).to(
        scene.mat_type.device)

    def edge_maps(img):
        return img[:, 1:] - img[:, :-1], img[1:, :] - img[:-1, :]

    losses = []
    stage_lr = lr
    for k in pyramid:
        tgt = _avg_pool(target, k)
        opt = adam([lf, la], stage_lr)
        for _ in range(steps // len(pyramid)):
            opt.zero_grad()
            img = soft_render(scene, cam_with_pose(init_cam,
                                                   PoseState(lf, la)),
                              img_width, img_height, soft)
            if objective == "edges":
                # a floor, not 0: sqrt'(0) is infinite and would reach the
                # pose gradient from black pixels
                img = torch.sqrt(vec.maximum(img, 1e-8))  # target is gamma
                ix, iy = edge_maps(_avg_pool(img, k))
                tx, ty = edge_maps(tgt)
                loss = (torch.mean((ix - tx) ** 2)
                        + torch.mean((iy - ty) ** 2))
            else:
                loss = torch.mean((_avg_pool(img, k) - tgt) ** 2)
            loss.backward()
            if not optimize_lookat:
                la.grad.zero_()
            opt.step()
            losses.append(float(loss.detach()))
        stage_lr *= 0.5
    return PoseState(lf.detach(), la.detach()), losses


def refine_pose_fd(scene: Scene, target: torch.Tensor, init_cam: CameraConfig,
                   img_width: int, img_height: int, *,
                   samples_per_pixel: int = 16, max_depth: int = 8,
                   steps: int = 60, lr: float = 2e-2, eps: float = 2e-2,
                   optimize_lookat: bool = True, render_fn=None,
                   log_every: int = 5):
    """Pose refinement on the real path-traced MSE by central finite
    differences, on the scene's device.

    The render is deterministic given (config, seed), so the MSE against
    a fixed target is a noise-free function of the pose, and central
    differences capture the boundary terms the detached-sampler gradient
    drops. The pose has 6 dimensions: 12 renders a step. Use after
    ``recover_pose`` (its basin is wider; this stage closes the gap
    between the surrogate's shading and the path tracer's).

    ``render_fn(cam_cfg) -> (H, W, 3)`` replaces the forward model, by
    default ``render_kernel.render_kernel`` on the scene's device (the
    regen kernel on the card, its plain version on the CPU; the JAX
    package defaults to its oracle, the same estimator). The pose stays
    on the host, as the camera config does. ``log_every``: the history
    costs one more render a point (central differences never evaluate
    the centre), so it is sampled every ``log_every`` steps and at the
    last. Returns (PoseState, MSE history; the last entry is the final
    MSE)."""
    if render_fn is None:
        from .render_kernel import render_kernel

        def render_fn(c):
            return render_kernel(scene, c, img_width, img_height,
                                 samples_per_pixel, max_depth)
    target = torch.as_tensor(target, dtype=torch.float32).to(
        scene.mat_type.device)

    def mse(x):
        img = render_fn(cam_with_pose(init_cam, PoseState(x[:3], x[3:])))
        return float(torch.mean((img - target) ** 2))

    start = pose_of(init_cam)
    x = torch.cat([start.lookfrom, start.lookat]).detach().cpu().clone()
    n_free = 6 if optimize_lookat else 3
    opt = adam([x], lr)
    history = []
    for it in range(steps):
        g = np.zeros(6, np.float32)
        for k in range(n_free):
            e = torch.zeros(6)
            e[k] = eps
            g[k] = (mse(x + e) - mse(x - e)) / (2.0 * eps)
        x.grad = torch.from_numpy(g)
        opt.step()
        if it == steps - 1 or (log_every and it % log_every == 0):
            history.append(mse(x))
    return PoseState(x[:3].clone(), x[3:].clone()), history
