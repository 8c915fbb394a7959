"""Checkpoints (utils/checkpoint.py) and the inverse-rendering example.

A render resumed from a checkpoint adds up to the single pass; a train
state round-trips bit for bit, a resumed run equals an uninterrupted one
bit for bit, and loading refuses a leaf whose dtype differs from the
template's (the JAX package casts there). On the CPU the kernel paths run
the kernels' plain versions.
"""
import os
import sys

import numpy as np
import pytest
import torch

from raytracingincuda_torch.config import RenderConfig
from raytracingincuda_torch.examples import inverse_rendering
from raytracingincuda_torch.models.camera import CameraConfig
from raytracingincuda_torch.models.scene import (SceneParams, build_scene,
                                                 param_leaves,
                                                 params_from_leaves)
from raytracingincuda_torch.ops import grad as tgrad
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops.vec import Vec3
from raytracingincuda_torch.utils import checkpoint as ck

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


@pytest.mark.parametrize("impl", ["kernel", "oracle"])
def test_render_incremental_resumes(tmp_path, impl):
    cfg = RenderConfig(scene_id=2, width=W, height=H, samples=4, bounces=4,
                       impl=impl, rr_start=1)
    s, cam = build_scene(2), CameraConfig.reference_default()
    single = ck.render_incremental(s, cam, cfg)
    path = str(tmp_path / "render")
    part = rk.render_kernel(s, cam, W, H, 2, 4, rr_start=1,
                            accumulate_only=True)
    ck.save_checkpoint(path, part.numpy(), 2, cfg)
    resumed = ck.render_incremental(s, cam, cfg, checkpoint_path=path,
                                    samples_per_round=1)
    # the sum of [0, 2) + [2, 3) + [3, 4) in another order than [0, 4)
    np.testing.assert_allclose(resumed, single, rtol=0, atol=1e-6)
    acc, done = ck.load_checkpoint(path, cfg)
    assert done == 4 and os.path.exists(path + ".npz")
    with pytest.raises(ValueError, match="different render config"):
        ck.load_checkpoint(path, RenderConfig(scene_id=2, width=W, height=H,
                                              samples=5, bounces=4))


def _setup():
    s = build_scene(2, pad_to_multiple=64)
    gray = torch.full_like(s.params.albedo.x, 0.5)
    start = s.params._replace(albedo=Vec3(gray, gray, gray))
    init_fn, step_fn = tgrad.make_train_step(
        W, H, SPP, DEPTH, learning_rate=5e-2, impl="fused",
        trainable=SceneParams(Vec3(False, False, False), False,
                              Vec3(True, True, True), False, False))
    target = rk.render_kernel(s, CameraConfig.reference_default(), W, H, SPP,
                              DEPTH, gamma=False)

    def steps(state, n):
        for _ in range(n):
            state, _ = step_fn(state, CameraConfig.reference_default(),
                               s.mat_type, s.active, target)
        return state

    return init_fn(start), steps


def test_resumed_training_equals_uninterrupted(tmp_path):
    state0, steps = _setup()
    straight = steps(state0, 4)
    half = steps(state0, 2)
    path = str(tmp_path / "train")
    ck.save_train_state(path, half, token="albedo fit")
    loaded = ck.load_train_state(path, state0, token="albedo fit")
    for a, b in zip(tgrad.train_state_leaves(loaded),
                    tgrad.train_state_leaves(half)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    resumed = steps(loaded, 2)
    for a, b in zip(tgrad.train_state_leaves(resumed),
                    tgrad.train_state_leaves(straight)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="different run"):
        ck.load_train_state(path, state0, token="another fit")


def test_load_train_state_refuses_dtype_drift(tmp_path):
    state0, _ = _setup()
    path = str(tmp_path / "train")
    ck.save_train_state(path, state0)
    drifted = state0._replace(params=params_from_leaves(
        [t.double() for t in param_leaves(state0.params)]))
    with pytest.raises(ValueError, match="refusing to cast"):
        ck.load_train_state(path, drifted)
    count64 = state0._replace(step=state0.step.long())
    with pytest.raises(ValueError, match="dtype"):
        ck.load_train_state(path, count64)


@pytest.mark.parametrize("impl", ["fused", "kernel", "stream"])
def test_example_runs_three_steps(tmp_path, impl):
    """The example's fit lowers the loss; ``--impl stream`` fits the same
    scene through make_stream_train."""
    out = str(tmp_path / "recovered.ppm")
    args = inverse_rendering.build_parser().parse_args(
        ["--device", "cpu", "--impl", impl, "--steps", "3", "--width", "24",
         "--height", "16", "--samples", "2", "--bounces", "3", "--out", out])
    losses = inverse_rendering.run(args)
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert os.path.getsize(out) > 0
