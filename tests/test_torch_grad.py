"""Gradients and the train step (ops/grad.py) against the JAX package.

JAX runs op by op (``jax.disable_jit()``), where its arithmetic is the
port's but for its rsqrt estimate (ROADMAP queue 3), so gradients agree
to a small fraction of each array's largest entry; each test states it.
On the CPU the kernel paths run the kernels' plain versions.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import scene_from_spheres
from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.camera import (config_from_leaves,
                                                  config_leaves)
from raytracingincuda_torch.models.convert import (scene_from_numpy,
                                                   train_state_from_numpy)
from raytracingincuda_torch.models.scene import (Scene, SceneParams,
                                                 param_leaves,
                                                 params_from_leaves)
from raytracingincuda_torch.ops import grad as tgrad
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import tracer as ttr
from raytracingincuda_torch.ops import train_kernel as tk
from raytracingincuda_torch.ops.vec import Vec3 as TV
from raytracingincuda_tpu.models.camera import CameraConfig as JCam
from raytracingincuda_tpu.models.scene import DIELECTRIC, LAMBERTIAN, METAL
from raytracingincuda_tpu.models.scene import Scene as JScene
from raytracingincuda_tpu.models.scene import SceneParams as JParams
from raytracingincuda_tpu.ops import grad as jgrad
from raytracingincuda_tpu.ops import tracer as jtr
from raytracingincuda_tpu.ops.vec import Vec3 as JV

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)


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

W, H, SPP, DEPTH = 16, 8, 2, 3


def _mixed():
    return scene_from_spheres([
        dict(center=(0, -1000, 0), radius=1000.0, mat=LAMBERTIAN,
             albedo=(0.5, 0.5, 0.5)),
        dict(center=(0, 1, 0), radius=1.0, mat=DIELECTRIC, ior=1.5),
        dict(center=(-2, 1, 0), radius=1.0, mat=LAMBERTIAN,
             albedo=(0.4, 0.2, 0.1)),
        dict(center=(2, 1, 0), radius=1.0, mat=METAL,
             albedo=(0.7, 0.6, 0.5), fuzz=0.1),
    ], pad_to=8)


def _port(jscene):
    return scene_from_numpy([np.asarray(x) for x in
                             jax.tree_util.tree_leaves(jscene)], device="cpu")


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_leaves_close(got, want, frac, what=""):
    """Each array leaf within ``frac`` of its own largest |entry|; the
    scalar leaves (the camera's 12) within ``frac`` of the largest of
    them, since some (vup) have gradients that are rounding noise."""
    assert len(got) == len(want)
    got = [g.detach().numpy() if isinstance(g, torch.Tensor)
           else np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    scalar_scale = max([float(np.abs(w).max()) for w in want if w.ndim == 0]
                       or [0.0])
    for k, (g, w) in enumerate(zip(got, want)):
        scale = float(np.abs(w).max()) if w.ndim else scalar_scale
        assert np.isfinite(g).all(), (what, k)
        np.testing.assert_allclose(g, w, rtol=0, atol=frac * max(scale, 1e-6),
                                   err_msg=f"{what} leaf {k}")


def _torch_grads(scene, fn):
    leaves = [t.clone().requires_grad_(True)
              for t in param_leaves(scene.params)]
    loss = fn(Scene(params_from_leaves(leaves), scene.mat_type, scene.active))
    return torch.autograd.grad(loss, leaves)


def test_rr_clip_tie_gradient_matches_jax():
    """A metal of albedo (1, 0.9, 0.8) and fuzz 0 under RR from bounce 0:
    after the first bounce the path's largest channel is exactly 1, the
    upper bound of p_surv = clip(max channel, 0.05, 1). JAX's clip passes
    half the gradient there; torch.clamp passed all of it, so the metal's
    albedo-r gradient was wrong before the port's bounds took JAX's tie
    rule (ROADMAP queue 3)."""
    js = scene_from_spheres([
        dict(center=(0, -1000, 0), radius=1000.0, mat=LAMBERTIAN,
             albedo=(0.5, 0.5, 0.5)),
        dict(center=(0, 1, 0), radius=1.0, mat=METAL,
             albedo=(1.0, 0.9, 0.8), fuzz=0.0),
    ], pad_to=8)
    weights = np.random.default_rng(2).random((H, W, 3)).astype(np.float32)
    kw = dict(gamma=False, rr_start=0)

    def jloss(p):
        img = jtr.render(JScene(p, js.mat_type, js.active),
                         JCam.reference_default(), W, H, SPP, DEPTH, **kw)
        return jnp.sum(img * weights)

    with jax.disable_jit():
        want = jax.tree_util.tree_leaves(jax.grad(jloss)(js.params))
    got = _torch_grads(_port(js), lambda s: (ttr.render(
        s, TCam.reference_default(), W, H, SPP, DEPTH, **kw)
        * torch.from_numpy(weights)).sum())
    # the metal's albedo-r gradient (slot 1) is where the tie shows
    assert abs(float(want[4][1])) > 1e-2
    _assert_leaves_close(got, want, 1e-3, "rr clip tie")


@pytest.mark.parametrize("loss", ["mse", "l1", "huber", "relmse"])
def test_image_loss_matches_jax(loss):
    rng = np.random.default_rng(3)
    img, tgt = (rng.random((H, W, 3)).astype(np.float32) for _ in range(2))
    img[0, 0] = tgt[0, 0]
    want = float(jgrad.image_loss(jnp.asarray(img), jnp.asarray(tgt), loss,
                                  0.25))
    got = float(tgrad.image_loss(torch.from_numpy(img), torch.from_numpy(tgt),
                                 loss, 0.25))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture(scope="module")
def target():
    rng = np.random.default_rng(1)
    return rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)


def test_render_grads_oracle_matches_jax(target):
    """Autograd through the port's oracle vs jax.value_and_grad through
    the JAX oracle, both op by op: loss to 1e-5, gradients to 1e-3 of
    each leaf's largest entry."""
    js = _mixed()
    cam = JCam.reference_default()
    with jax.disable_jit():
        jl, (jp, jc) = jgrad.render_grads(js, cam, jnp.asarray(target), W, H,
                                          SPP, DEPTH, rr_start=1)
    tl, (tp, tc) = tgrad.render_grads(_port(js), TCam.reference_default(),
                                      torch.from_numpy(target), W, H, SPP,
                                      DEPTH, rr_start=1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_leaves_close(param_leaves(tp), _leaves_np(jp), 1e-3, "params")
    _assert_leaves_close(config_leaves(tc), _leaves_np(jc), 1e-3, "camera")


@pytest.mark.parametrize("gamma", [False, True])
def test_make_diff_render_kernel_backward_matches_oracle(target, gamma):
    """The autograd.Function: forward is render_kernel, and its gradient
    kernel backward (plain version here) agrees with autograd through the
    oracle to 1e-4 of each leaf's largest entry."""
    s = _port(_mixed())
    cam = TCam.reference_default()
    tgt = torch.from_numpy(target)
    outs = {}
    for backward in ("kernel", "oracle"):
        f = rk.make_diff_render(s.mat_type, s.active, W, H, SPP, DEPTH,
                                gamma=gamma, backward=backward, rr_start=1)
        p = [t.clone().requires_grad_(True) for t in param_leaves(s.params)]
        c = [t.clone().requires_grad_(True) for t in config_leaves(cam)]
        img = f(params_from_leaves(p), config_from_leaves(c))
        assert torch.equal(img.detach(), rk.render_kernel(
            s, cam, W, H, SPP, DEPTH, gamma=gamma, rr_start=1))
        loss = tgrad.image_mse(img, tgt)
        outs[backward] = torch.autograd.grad(loss, p + c)
    _assert_leaves_close(outs["kernel"], [o.numpy() for o in outs["oracle"]],
                         1e-4, f"gamma={gamma}")


def _jax_state_after(js, trainable, steps, target):
    """A JAX TrainState (optax.adam) after ``steps`` oracle steps, run op
    by op, and the one step after it."""
    init_fn, step_fn = jgrad.make_train_step(W, H, SPP, DEPTH,
                                             learning_rate=1e-2,
                                             trainable=trainable)
    state = init_fn(js.params)
    cam = JCam.reference_default()
    with jax.disable_jit():
        for _ in range(steps):
            state, _ = step_fn(state, cam, js.mat_type, js.active, target)
        nxt, loss = step_fn(state, cam, js.mat_type, js.active, target)
    return state, nxt, loss


@pytest.mark.parametrize("masked", [False, True])
def test_carried_train_step_matches_jax(target, masked):
    """A JAX TrainState after one step, carried into the port, then one
    more step on each side: params, moments, count and step agree.
    optax adds eps after bias-correcting sqrt(nu) and torch divides by
    sqrt(bias_correction2) first; equal in exact arithmetic, so new
    params are held to 1e-4 of the learning rate plus 1e-6 of each
    leaf, and moments to 2e-3 of each leaf's largest entry."""
    js = _mixed()
    jtgt = jnp.asarray(target)
    jmask = tmask = None
    if masked:
        jmask = JParams(center=JV(False, False, False), radius=False,
                        albedo=JV(True, True, True), fuzz=True, ior=False)
        tmask = SceneParams(center=TV(False, False, False), radius=False,
                            albedo=TV(True, True, True), fuzz=True,
                            ior=False)
    state, nxt, jloss = _jax_state_after(js, jmask, 1, jtgt)
    carried = train_state_from_numpy(_leaves_np(state), trainable=tmask,
                                     device="cpu")
    s = _port(js)
    init_fn, step_fn = tgrad.make_train_step(W, H, SPP, DEPTH,
                                             learning_rate=1e-2,
                                             trainable=tmask)
    assert [t.dtype for t in tgrad.train_state_leaves(carried)] == [
        t.dtype for t in tgrad.train_state_leaves(init_fn(s.params))]
    new, tloss = step_fn(carried, TCam.reference_default(), s.mat_type,
                         s.active, torch.from_numpy(target))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = train_state_from_numpy(_leaves_np(nxt), trainable=tmask,
                                  device="cpu")
    got_p, want_p = param_leaves(new.params), param_leaves(want.params)
    for k, (g, w) in enumerate(zip(got_p, want_p)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"param {k}")
    frozen = [not m for m in ([True] * 9 if tmask is None
                              else [bool(t) for t in param_leaves(tmask)])]
    before = param_leaves(carried.params)
    for k in range(9):
        if frozen[k]:
            assert torch.equal(got_p[k], before[k]), f"frozen leaf {k} moved"
            assert not param_leaves(new.opt_state.mu)[k].any()
    for name in ("mu", "nu"):
        _assert_leaves_close(param_leaves(getattr(new.opt_state, name)),
                             [w.numpy() for w in param_leaves(
                                 getattr(want.opt_state, name))], 2e-3, name)
    assert int(new.opt_state.count) == int(want.opt_state.count) == 2
    assert int(new.step) == int(want.step) == 2


@pytest.mark.parametrize("impl", ["oracle", "kernel", "fused"])
def test_loss_falls(target, impl):
    """Three Adam steps on the albedos from gray lower the loss."""
    s = _port(_mixed())
    gray = torch.full_like(s.params.albedo.x, 0.5)
    start = s.params._replace(albedo=TV(gray, gray, gray))
    init_fn, step_fn = tgrad.make_train_step(
        W, H, SPP, DEPTH, learning_rate=5e-2, impl=impl,
        trainable=SceneParams(TV(False, False, False), False,
                              TV(True, True, True), False, False))
    tgt = rk.render_kernel(s, TCam.reference_default(), W, H, SPP, DEPTH,
                           gamma=False)
    state = init_fn(start)
    losses = []
    for _ in range(3):
        state, loss = step_fn(state, TCam.reference_default(), s.mat_type,
                              s.active, tgt)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_unported_axes_and_misuse_raise():
    s = _port(_mixed())
    cam = TCam.reference_default()
    with pytest.raises(TypeError, match="Mesh"):
        tgrad.make_loss_fn(W, H, SPP, DEPTH, mesh=object())
    # float64 has gradients through the oracle only, as in JAX
    with pytest.raises(NotImplementedError, match="impl='oracle'"):
        tgrad.make_loss_fn(W, H, SPP, DEPTH, impl="kernel",
                           dtype=torch.float64)
    # streamed scenes train through make_stream_train, which the refusals
    # name (the JAX make_loss_fn runs its oracle for impl='stream')
    with pytest.raises(ValueError, match="make_stream_train"):
        tgrad.make_loss_fn(W, H, SPP, DEPTH, impl="stream")
    with pytest.raises(ValueError, match="make_stream_train"):
        tgrad.make_loss_fn(W, H, SPP, DEPTH, impl="kernel", layout="packed")
    with pytest.raises(ValueError, match="make_stream_train"):
        tk.fused_train(s, cam, torch.zeros((H, W, 3)), W, H, SPP, DEPTH,
                       layout="packed")
    with pytest.raises(ValueError, match="make_stream_train"):
        tgrad.make_train_step(W, H, SPP, DEPTH, impl="stream")
    from raytracingincuda_torch.ops.stream_kernel import prepare_stream_scene

    stream = prepare_stream_scene(s, block=2)
    with pytest.raises(TypeError, match="Mesh"):
        tgrad.make_stream_train(stream, W, H, SPP, DEPTH, mesh=object())
    border = tgrad.front_to_back_border(stream, cam, W, H)
    assert sorted(border.tolist()) == list(range(stream.n_blocks))
    with pytest.raises(ValueError, match="ray_tile"):
        tgrad.make_loss_fn(W, H, SPP, DEPTH, ray_tile=128)
    with pytest.raises(ValueError, match="backward='oracle'"):
        rk.make_diff_render(s.mat_type, s.active, W, H, SPP, DEPTH,
                            legacy_sky=True)
    with pytest.raises(TypeError, match="Mesh"):
        tk.render_kernel_grads(s, cam, torch.zeros((H, W, 3)), W, H, SPP,
                               DEPTH, mesh=object())
    with pytest.raises(NotImplementedError, match="impl='oracle'"):
        tk.fused_train(s, cam, torch.zeros((H, W, 3)), W, H, SPP, DEPTH,
                       dtype=torch.float64)
    ids, ii, jj, _, sm, row = rk.regen_inputs(s, cam, W, H, SPP)
    rows = torch.zeros((3, ids.shape[0]))
    with pytest.raises(ValueError, match="CUDA"):
        tk.grad_kernel(ids, ii, jj, rows, sm, row, samples=SPP,
                       max_depth=DEPTH)
    with pytest.raises(ValueError, match="CUDA"):
        tk.fused_train_kernel(ids, ii, jj, rows, sm, row, samples=SPP,
                              max_depth=DEPTH, num_pixels=W * H)
    # the oracle backward keeps legacy_sky
    f = rk.make_diff_render(s.mat_type, s.active, W, H, SPP, DEPTH,
                            legacy_sky=True, backward="oracle")
    p = [t.clone().requires_grad_(True) for t in param_leaves(s.params)]
    f(params_from_leaves(p), cam).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in p)
