"""The train steps' ``optimizer`` argument (ops/grad.py) against JAX's.

Three steps of ``make_train_step(optimizer=SGD with momentum)`` from one
start, against JAX's ``make_train_step(optimizer=optax.sgd(lr,
momentum))`` run op by op, within 1e-6 of every parameter. The state of
such a step is an ``OptimizerState``, which ``utils/checkpoint.py``
saves and loads key by key: SGD-momentum and AdamW runs resumed from a
file equal uninterrupted ones bit for bit, through ``make_train_step``
and ``make_stream_train``, and a resumed SGD run stays within 1e-6 of
optax.sgd's run resumed through JAX's own checkpoint. Loading refuses
another optimizer's file, and an Adam file in the 29-leaf layout loads.
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
from raytracingincuda_torch.utils.checkpoint import (load_train_state,
                                                     save_train_state)
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
                          for x in jax.tree_util.tree_leaves(js)],
                         device="cpu")
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
    the state round-trips through save_train_state / load_train_state
    bit for bit, its per-leaf structure taken from the file (the fresh
    template holds empty dicts)."""
    from raytracingincuda_torch.models.scene import build_random_scene
    from raytracingincuda_torch.ops import stream_kernel as sk

    scene = build_random_scene(200, half_extent=10.0, device="cpu")
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
        tgrad.train_state_leaves(s2)
    save_train_state(str(tmp_path / "ck.npz"), s2, token="stream sgd")
    template = init_fn(scene.params)
    assert all(st == {} for st in template.opt_state.per_leaf)
    loaded = load_train_state(str(tmp_path / "ck.npz"), template,
                              token="stream sgd")
    _assert_states_equal(loaded, s2)


def _assert_states_equal(a, b):
    """Params, count, step, the optimizer's name and every per-leaf state
    entry (key, kind, device, dtype and bits) equal."""
    for x, y in zip(param_leaves(a.params), param_leaves(b.params)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in ((a.opt_state.count, b.opt_state.count), (a.step, b.step)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.opt_state.name == b.opt_state.name
    for sa, sb in zip(a.opt_state.per_leaf, b.opt_state.per_leaf):
        assert list(sa) == list(sb)
        for k in sa:
            va, vb = sa[k], sb[k]
            if torch.is_tensor(vb):
                assert (torch.is_tensor(va) and va.device == vb.device
                        and va.dtype == vb.dtype and torch.equal(va, vb)), k
            else:
                assert type(va) is type(vb) and va == vb, k


class _SGDWithNumbers(torch.optim.SGD):
    """SGD whose per-parameter state also holds a Python int, a Python
    float and None, kinds that torch.optim states may hold beside
    tensors; the int scales the next step."""

    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["calls"] = st.get("calls", 0) + 1
                st["scale"] = 1.0 / (1.0 + st["calls"])
                st["spare"] = None
                if p.grad is not None:
                    p.grad.mul_(st["scale"])
        return super().step(closure)


OPTIMIZERS = {
    "sgd_momentum": functools.partial(torch.optim.SGD, lr=LR,
                                      momentum=MOMENTUM),
    "adamw": functools.partial(torch.optim.AdamW, lr=LR, weight_decay=0.05),
    "numbers": functools.partial(_SGDWithNumbers, lr=LR, momentum=MOMENTUM),
}


def _train(entry, optimizer):
    """(init_fn, steps(state, n), start params) for one entry point: the
    fused step on scene 2's albedos and fuzz, or the fused stream step on
    200 random spheres' albedos."""
    from raytracingincuda_torch.models.scene import build_random_scene
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import stream_kernel as sk

    mask = SceneParams(center=TV(False, False, False), radius=False,
                       albedo=TV(True, True, True), fuzz=entry == "train",
                       ior=False)
    cam = TCam.reference_default()
    if entry == "train":
        scene = scene_from_numpy([np.asarray(x) for x in
                                  jax.tree_util.tree_leaves(_scene())],
                                 device="cpu")
        init_fn, step_fn = tgrad.make_train_step(
            W, H, SPP, DEPTH, OPTIMIZERS[optimizer], trainable=mask,
            impl="fused")
    else:
        scene = build_random_scene(200, half_extent=10.0, device="cpu")
        init_fn, step_fn = tgrad.make_stream_train(
            sk.prepare_stream_scene(scene, block=64), W, H, SPP, DEPTH,
            OPTIMIZERS[optimizer], trainable=mask)
    target = rk.render_kernel(scene, cam, W, H, SPP, DEPTH, gamma=False)
    gray = torch.full_like(scene.params.albedo.x, 0.5)
    start = scene.params._replace(albedo=TV(gray, gray, gray))

    def steps(state, n):
        for _ in range(n):
            state, _ = step_fn(state, cam, scene.mat_type, scene.active,
                               target)
        return state

    return init_fn, steps, start


@pytest.mark.parametrize("entry", ["train", "stream_train"])
@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
def test_resumed_run_equals_uninterrupted(tmp_path, optimizer, entry):
    """Three steps straight against one step, a checkpoint, a load onto a
    fresh template and two steps: params and optimizer state bit-equal."""
    init_fn, steps, start = _train(entry, optimizer)
    straight = steps(init_fn(start), 3)
    one = steps(init_fn(start), 1)
    path = str(tmp_path / "train")
    save_train_state(path, one, token=f"{entry} {optimizer}")
    loaded = load_train_state(path, init_fn(start),
                              token=f"{entry} {optimizer}")
    _assert_states_equal(loaded, one)
    resumed = steps(loaded, 2)
    _assert_states_equal(resumed, straight)
    assert int(resumed.step) == int(resumed.opt_state.count) == 3
    moved = float((resumed.params.albedo.x - start.albedo.x).abs().max())
    assert moved > 0.0


def test_sgd_resumed_from_file_matches_optax(tmp_path):
    """One SGD-momentum step, save_train_state, load_train_state, two
    steps, against optax.sgd's run with JAX's own save_train_state /
    load_train_state in the same place (run op by op): every parameter
    within 1e-6, as the uninterrupted runs."""
    from raytracingincuda_tpu.utils import checkpoint as jck

    js = _scene()
    target = np.random.default_rng(7).random((H, W, 3)).astype(np.float32)
    init_j, step_j = jgrad.make_train_step(
        W, H, SPP, DEPTH, optimizer=optax.sgd(LR, momentum=MOMENTUM))

    def steps_j(state, n):
        for _ in range(n):
            state, _ = step_j(state, JCam.reference_default(), js.mat_type,
                              js.active, jnp.asarray(target))
        return state

    with jax.disable_jit():
        state_j = steps_j(init_j(js.params), 1)
        jck.save_train_state(str(tmp_path / "jax"), state_j, token="sgd")
        state_j = steps_j(jck.load_train_state(
            str(tmp_path / "jax"), init_j(js.params), token="sgd"), 2)

    s = scene_from_numpy([np.asarray(x)
                          for x in jax.tree_util.tree_leaves(js)],
                         device="cpu")
    init_t, step_t = tgrad.make_train_step(W, H, SPP, DEPTH,
                                           OPTIMIZERS["sgd_momentum"])

    def steps_t(state, n):
        for _ in range(n):
            state, _ = step_t(state, TCam.reference_default(), s.mat_type,
                              s.active, torch.from_numpy(target))
        return state

    save_train_state(str(tmp_path / "port"), steps_t(init_t(s.params), 1),
                     token="sgd")
    state = steps_t(load_train_state(str(tmp_path / "port"),
                                     init_t(s.params), token="sgd"), 2)
    got = param_leaves(state.params)
    want = jax.tree_util.tree_leaves(state_j.params)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6, err_msg=f"param {k}")
    assert int(state.step) == 3


def test_load_refuses_another_optimizer(tmp_path):
    """A file of one optimizer does not load onto another's template:
    SGD onto AdamW or onto the default Adam, and Adam onto SGD."""
    init_sgd, steps, start = _train("train", "sgd_momentum")
    init_adamw, _, _ = _train("train", "adamw")
    init_adam, _ = tgrad.make_train_step(W, H, SPP, DEPTH, impl="fused")
    save_train_state(str(tmp_path / "sgd"), steps(init_sgd(start), 1))
    for template in (init_adamw(start), init_adam(start)):
        with pytest.raises(ValueError, match="holds the state of SGD"):
            load_train_state(str(tmp_path / "sgd"), template)
    save_train_state(str(tmp_path / "adam"), init_adam(start))
    with pytest.raises(ValueError, match="template's optimizer is SGD"):
        load_train_state(str(tmp_path / "adam"), init_sgd(start))


def test_adam_file_in_the_29_leaf_layout_loads(tmp_path):
    """An Adam checkpoint as the 29-leaf layout writes it (token,
    n_leaves, leaf_0 .. leaf_28: params, count, mu, nu, step), built here
    with numpy alone, loads bit for bit, and save_train_state still
    writes exactly those arrays."""
    init_fn, step_fn = tgrad.make_train_step(W, H, SPP, DEPTH, impl="fused")
    s = scene_from_numpy([np.asarray(x) for x in
                          jax.tree_util.tree_leaves(_scene())], device="cpu")
    target = torch.zeros((H, W, 3))
    state, _ = step_fn(init_fn(s.params), TCam.reference_default(),
                       s.mat_type, s.active, target)
    leaves = tgrad.train_state_leaves(state)
    arrays = {f"leaf_{i}": v.numpy() for i, v in enumerate(leaves)}
    np.savez(str(tmp_path / "old.npz"), token=np.frombuffer(b"fit", np.uint8),
             n_leaves=np.int64(29), **arrays)
    loaded = load_train_state(str(tmp_path / "old.npz"), init_fn(s.params),
                              token="fit")
    assert isinstance(loaded.opt_state, tgrad.AdamState)
    for a, b in zip(tgrad.train_state_leaves(loaded), leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    save_train_state(str(tmp_path / "new.npz"), state, token="fit")
    z = np.load(str(tmp_path / "new.npz"))
    assert sorted(z.files) == sorted(["token", "n_leaves", *arrays])
    for k, v in arrays.items():
        np.testing.assert_array_equal(z[k], v)
