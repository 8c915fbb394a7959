"""The train steps' ``optimizer`` argument (ops/grad.py) against JAX's.

Three steps of ``make_train_step(optimizer=SGD with momentum)`` from one
start, against JAX's ``make_train_step(optimizer=optax.sgd(lr,
momentum))`` run op by op, within 1e-6 of every parameter; the state of
such a step is an ``OptimizerState``, which checkpoints refuse by name.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import scene_from_spheres
from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.convert import scene_from_numpy
from raytracingincuda_torch.models.scene import SceneParams, param_leaves
from raytracingincuda_torch.ops import grad as tgrad
from raytracingincuda_torch.ops.vec import Vec3 as TV
from raytracingincuda_torch.utils.checkpoint import save_train_state
from raytracingincuda_tpu.models.camera import CameraConfig as JCam
from raytracingincuda_tpu.models.scene import DIELECTRIC, LAMBERTIAN, METAL
from raytracingincuda_tpu.models.scene import SceneParams as JParams
from raytracingincuda_tpu.ops import grad as jgrad
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
LR, MOMENTUM = 2e-2, 0.9


def _scene():
    return scene_from_spheres([
        dict(center=(0, -1000, 0), radius=1000.0, mat=LAMBERTIAN,
             albedo=(0.5, 0.5, 0.5)),
        dict(center=(0, 1, 0), radius=1.0, mat=DIELECTRIC, ior=1.5),
        dict(center=(-2, 1, 0), radius=1.0, mat=LAMBERTIAN,
             albedo=(0.4, 0.2, 0.1)),
        dict(center=(2, 1, 0), radius=1.0, mat=METAL,
             albedo=(0.7, 0.6, 0.5), fuzz=0.1),
    ], pad_to=8)


@pytest.mark.parametrize("masked", [False, True])
def test_sgd_momentum_steps_match_jax(masked):
    """Three SGD-with-momentum steps on both sides: every parameter within
    1e-6 (the losses' gradients differ in the last bits), frozen leaves
    unmoved and without optimizer state."""
    js = _scene()
    target = np.random.default_rng(7).random((H, W, 3)).astype(np.float32)
    jmask = tmask = None
    if masked:
        jmask = JParams(center=JV(False, False, False), radius=False,
                        albedo=JV(True, True, True), fuzz=True, ior=False)
        tmask = SceneParams(center=TV(False, False, False), radius=False,
                            albedo=TV(True, True, True), fuzz=True,
                            ior=False)
    init_j, step_j = jgrad.make_train_step(
        W, H, SPP, DEPTH, optimizer=optax.sgd(LR, momentum=MOMENTUM),
        trainable=jmask)
    state_j = init_j(js.params)
    with jax.disable_jit():
        for _ in range(3):
            state_j, loss_j = step_j(state_j, JCam.reference_default(),
                                     js.mat_type, js.active,
                                     jnp.asarray(target))

    s = scene_from_numpy([np.asarray(x)
                          for x in jax.tree_util.tree_leaves(js)])
    init_t, step_t = tgrad.make_train_step(
        W, H, SPP, DEPTH, functools.partial(torch.optim.SGD, lr=LR,
                                            momentum=MOMENTUM),
        trainable=tmask)
    state = init_t(s.params)
    start = param_leaves(state.params)
    for _ in range(3):
        state, loss_t = step_t(state, TCam.reference_default(), s.mat_type,
                               s.active, torch.from_numpy(target))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    got = param_leaves(state.params)
    want = jax.tree_util.tree_leaves(state_j.params)
    mask = [True] * 9 if tmask is None else [bool(t) for t in
                                               param_leaves(tmask)]
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6, err_msg=f"param {k}")
        st = state.opt_state.per_leaf[k]
        if mask[k]:
            assert "momentum_buffer" in st
        else:
            assert torch.equal(g, start[k]) and st == {}
    moved = max(float((g - s0).abs().max()) for g, s0 in zip(got, start))
    assert moved > 1e-3
    assert isinstance(state.opt_state, tgrad.OptimizerState)
    assert state.opt_state.name == "SGD"
    assert int(state.opt_state.count) == int(state.step) == 3


def test_optimizer_state_is_functional_and_refused_by_checkpoints(tmp_path):
    """A step leaves the state it was given unchanged (its momentum
    buffers are copies), a stream train step takes the optimizer too, and
    save_train_state refuses the state, naming it."""
    from raytracingincuda_torch.models.scene import build_random_scene
    from raytracingincuda_torch.ops import stream_kernel as sk

    scene = build_random_scene(200, half_extent=10.0)
    target = torch.zeros((H, W, 3))
    sgd = functools.partial(torch.optim.SGD, lr=LR, momentum=MOMENTUM)
    mask = SceneParams(center=TV(False, False, False), radius=False,
                       albedo=TV(True, True, True), fuzz=False, ior=False)
    init_fn, step_fn = tgrad.make_stream_train(
        sk.prepare_stream_scene(scene, block=64), W, H, SPP, DEPTH, sgd,
        trainable=mask)
    s1, _ = step_fn(init_fn(scene.params), TCam.reference_default(),
                    scene.mat_type, scene.active, target)
    buf = s1.opt_state.per_leaf[4]["momentum_buffer"].clone()
    s2, _ = step_fn(s1, TCam.reference_default(), scene.mat_type,
                    scene.active, target)
    assert torch.equal(s1.opt_state.per_leaf[4]["momentum_buffer"], buf)
    assert not torch.equal(s2.params.albedo.x, s1.params.albedo.x)
    with pytest.raises(TypeError, match="OptimizerState of SGD"):
        save_train_state(str(tmp_path / "ck.npz"), s2)
    assert not (tmp_path / "ck.npz").exists()
