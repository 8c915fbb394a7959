"""Camera-pose recovery (ops/pose.py) against the JAX package.

``soft_render`` and its pose gradient are held to JAX's within stated
tolerances (the two differ in ``log_sigmoid``'s and softmax's last bits);
the gradient also to central differences, as the JAX test holds it; a
few ``recover_pose`` steps from one start to JAX's; ``refine_pose_fd``
converges on a real path-traced target (the regen kernel's plain
version), and its first step moves as JAX's does.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig
from raytracingincuda_torch.models.scene import build_scene
from raytracingincuda_torch.ops import pose as tpose
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_tpu.models.camera import CameraConfig as JCam
from raytracingincuda_tpu.models.scene import build_scene as j_build
from raytracingincuda_tpu.ops import pose as jpose

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

W, H = 32, 20
SHIFT = (0.3, -0.2, 0.25)


def _import_dynamo_past_benchmarks():
    """tests/test_multihost.py puts benchmarks/ first on sys.path while
    pytest collects, and its profile.py shadows the standard library
    module that torch.optim's first optimizer imports (torch._dynamo ->
    cProfile -> profile). Import those with benchmarks/ off the path."""
    if not hasattr(sys.modules.get("profile", sys), "run"):
        sys.modules.pop("profile", None)
    saved = list(sys.path)
    sys.path[:] = [p for p in saved
                   if os.path.basename(os.path.normpath(p)) != "benchmarks"]
    try:
        import torch._dynamo  # noqa: F401
    finally:
        sys.path[:] = saved


_import_dynamo_past_benchmarks()


def _shifted(pose, shift):
    """``pose`` (of either package) with its lookfrom moved by ``shift``."""
    if isinstance(pose.lookfrom, torch.Tensor):
        return pose._replace(lookfrom=pose.lookfrom + torch.tensor(shift))
    return pose._replace(lookfrom=pose.lookfrom
                         + jnp.asarray(shift, jnp.float32))


def test_soft_render_matches_jax(monkeypatch):
    """(H, W, 3) in [0, 1]. Against JAX as it runs, within atol 2e-4 and a
    mean |d| under 1e-6: XLA's CPU rsqrt is an estimate an ulp off on
    about 12% of inputs (ROADMAP queue 3), which moves a ray's unit
    direction, and the silhouette sigmoid's slope amplifies it. With JAX's
    unit vector taken through the correctly rounded rsqrt the port uses
    (``f32math.rsqrt``), within atol 2.4e-7 (2 ulp at 1)."""
    from raytracingincuda_tpu.ops import vec as jvec

    img = tpose.soft_render(build_scene(2, device="cpu"),
                            CameraConfig.reference_default(), W, H).numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0 and img.std() > 0.01

    def jax_img():
        return np.asarray(jpose.soft_render(j_build(2),
                                            JCam.reference_default(), W, H))

    d = np.abs(img - jax_img())
    assert d.max() <= 2e-4 and d.mean() <= 1e-6, (d.max(), d.mean())

    def unit(v, eps=1e-30):
        ls = np.maximum(np.asarray(jvec.length_sq(v)), eps)
        inv = (1.0 / np.sqrt(ls.astype(np.float64))).astype(np.float32)
        return v * jnp.asarray(inv)

    monkeypatch.setattr(jpose.vec, "unit", unit)
    np.testing.assert_allclose(img, jax_img(), rtol=0, atol=2.4e-7)


def _port_loss(scene, cam, target, w, h):
    def loss(lf, la):
        c = tpose.cam_with_pose(cam, tpose.PoseState(lf, la))
        return torch.mean((tpose.soft_render(scene, c, w, h) - target) ** 2)
    return loss


def test_pose_gradient_matches_jax_and_fd():
    """The surrogate's pose gradient against jax.grad (rtol 1e-3 + atol 1e-3
    of the largest entry) and against central differences of the port's own
    loss (the JAX test's bound: 2e-3 + 5% of the difference), the
    silhouette term included."""
    w, h = 64, 40
    scene, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    target = tpose.soft_render(scene, cam, w, h)
    pp = _shifted(tpose.pose_of(cam), SHIFT)
    lf = pp.lookfrom.clone().requires_grad_(True)
    la = pp.lookat.clone().requires_grad_(True)
    loss = _port_loss(scene, cam, target, w, h)
    g_lf, g_la = torch.autograd.grad(loss(lf, la), [lf, la])
    got = np.concatenate([g_lf.numpy(), g_la.numpy()])

    js, jc = j_build(2), JCam.reference_default()
    jt = jpose.soft_render(js, jc, w, h)
    jp = _shifted(jpose.pose_of(jc), SHIFT)

    def jloss(ps):
        c = jpose._cam_with_pose(jc, ps)
        return jnp.mean((jpose.soft_render(js, c, w, h) - jt) ** 2)

    jg = jax.grad(jloss)(jp)
    want = np.concatenate([np.asarray(jg.lookfrom), np.asarray(jg.lookat)])
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())

    eps = 1e-3
    with torch.no_grad():
        for j, base in enumerate((pp.lookfrom, pp.lookat)):
            for k in range(3):
                e = torch.zeros(3)
                e[k] = eps
                args = [pp.lookfrom, pp.lookat]
                hi, lo = list(args), list(args)
                hi[j], lo[j] = base + e, base - e
                fd = float((loss(*hi) - loss(*lo)) / (2 * eps))
                ad = float(got[3 * j + k])
                assert abs(fd - ad) < 2e-3 + 0.05 * abs(fd), (j, k, fd, ad)


def test_recover_pose_steps_match_jax():
    """Six steps of recover_pose (two a pyramid level) from one start
    against a soft target, as JAX takes them: poses within 2e-5 world
    units, losses within rtol 1e-3 (torch's Adam adds eps after the
    bias correction, optax before: a last-bit difference a step)."""
    scene, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    target = tpose.soft_render(scene, cam, W, H)
    init = tpose.cam_with_pose(cam, _shifted(tpose.pose_of(cam),
                                             (0.1, -0.05, 0.08)))
    got, losses = tpose.recover_pose(scene, target, init, W, H, steps=6)

    js, jc = j_build(2), JCam.reference_default()
    jinit = jpose._cam_with_pose(jc, _shifted(jpose.pose_of(jc),
                                             (0.1, -0.05, 0.08)))
    want, jlosses = jpose.recover_pose(js, jpose.soft_render(js, jc, W, H),
                                       jinit, W, H, steps=6)
    assert len(losses) == len(jlosses) == 6
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    np.testing.assert_allclose(got.lookfrom.numpy(),
                               np.asarray(want.lookfrom), atol=2e-5)
    np.testing.assert_allclose(got.lookat.numpy(), np.asarray(want.lookat),
                               atol=2e-5)
    moved = float(torch.linalg.norm(got.lookfrom
                                    - tpose.pose_of(init).lookfrom))
    assert moved > 0.05
    with pytest.raises(ValueError, match="objective"):
        tpose.recover_pose(scene, target, init, W, H, steps=1,
                           objective="l2")


def test_refine_pose_fd_first_step_as_jax():
    """One FD step moves the pose as JAX's does: Adam's first update is
    -lr * g / (|g| + eps), so it depends on each difference's sign, which
    the packages share although the images differ in a few last bits
    (amplified by 1 / (2 eps) = 25); within 1e-6 world units. The lookat
    stays put with optimize_lookat=False."""
    scene, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    target = rk.render_kernel(scene, cam, W, H, 2, 3)
    init = tpose.cam_with_pose(cam, _shifted(tpose.pose_of(cam),
                                             (0.12, -0.08, 0.1)))
    got, hist = tpose.refine_pose_fd(scene, target, init, W, H,
                                     samples_per_pixel=2, max_depth=3,
                                     steps=1, optimize_lookat=False)
    js, jc = j_build(2), JCam.reference_default()
    jinit = jpose._cam_with_pose(jc, _shifted(jpose.pose_of(jc),
                                             (0.12, -0.08, 0.1)))
    want, jhist = jpose.refine_pose_fd(js, jnp.asarray(target.numpy()),
                                       jinit, W, H, samples_per_pixel=2,
                                       max_depth=3, steps=1,
                                       optimize_lookat=False)
    np.testing.assert_allclose(got.lookfrom.numpy(),
                               np.asarray(want.lookfrom), atol=1e-6)
    assert torch.equal(got.lookat, tpose.pose_of(init).lookat)
    assert len(hist) == len(jhist) == 1


def test_refine_pose_fd_converges_on_real_target():
    """The FD stage descends the real path-traced MSE on the regen
    kernel's plain version: the MSE to under 0.35 of the start's and the
    lookfrom error to under half (the JAX test's bounds, at 40x24x2spp/4b
    and 20 steps here). Its default forward model is that render."""
    w, h, spp, depth = 40, 24, 2, 4
    scene, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    calls = []

    def render(c):
        calls.append(1)
        return rk.render_kernel(scene, c, w, h, spp, depth)

    target = render(cam)
    true = tpose.pose_of(cam)
    init = tpose.cam_with_pose(cam, true._replace(
        lookfrom=true.lookfrom + torch.tensor([0.12, -0.08, 0.1])))
    mse0 = float(torch.mean((render(init) - target) ** 2))
    kw = dict(samples_per_pixel=spp, max_depth=depth, optimize_lookat=False)
    rec, hist = tpose.refine_pose_fd(scene, target, init, w, h, steps=20,
                                     **kw)
    err0 = float(torch.linalg.norm(tpose.pose_of(init).lookfrom
                                   - true.lookfrom))
    err1 = float(torch.linalg.norm(rec.lookfrom - true.lookfrom))
    assert hist[-1] < 0.35 * mse0, (mse0, hist)
    assert err1 < 0.5 * err0, (err0, err1)
    # one step through an explicit render_fn: 6 renders and one logged
    n = len(calls)
    rec2, hist2 = tpose.refine_pose_fd(scene, target, init, w, h, steps=1,
                                       render_fn=render, **kw)
    assert len(calls) - n == 7
    rec3, hist3 = tpose.refine_pose_fd(scene, target, init, w, h, steps=1,
                                       **kw)
    assert hist2 == hist3 and torch.equal(rec2.lookfrom, rec3.lookfrom)
