"""Checkpoints (utils/checkpoint.py) and the inverse-rendering example.

A render resumed from a checkpoint adds up to the single pass; a train
state round-trips bit for bit, a resumed run equals an uninterrupted one
bit for bit, and loading refuses a leaf whose dtype differs from the
template's (the JAX package casts there). On the CPU the kernel paths run
the kernels' plain versions.
"""
import dataclasses
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
from raytracingincuda_torch.ops import tracer
from raytracingincuda_torch.render_api import make_renderer
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
    s, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
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


def _jax_incremental(dtype, **kw):
    """JAX's render_incremental at ROADMAP Queue 3 A's inputs (scene 2,
    24x16, 4 spp, 4 bounces, rounds of 2), with x64 on only inside the
    call for float64: JAX renders every round on its oracle."""
    import jax
    import jax.numpy as jnp

    from raytracingincuda_tpu.config import RenderConfig as JaxConfig
    from raytracingincuda_tpu.models.camera import CameraConfig as JaxCamera
    from raytracingincuda_tpu.models.scene import build_scene as jax_scene
    from raytracingincuda_tpu.utils import checkpoint as jck

    x64 = dtype == "float64"
    jax.config.update("jax_enable_x64", x64)
    try:
        dt = jnp.float64 if x64 else jnp.float32
        cfg = JaxConfig(scene_id=2, width=24, height=16, samples=4,
                        bounces=4, dtype=dtype, **kw)
        return np.asarray(jck.render_incremental(
            jax_scene(2, dtype=dt), JaxCamera.reference_default(dtype=dt),
            cfg, samples_per_round=2))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_render_incremental_float64_renders_in_double(tmp_path):
    """A float64 config renders every round on the f64 oracle, as JAX's
    render_incremental renders every round in the config's dtype; the
    port keeps the sum in double (JAX casts each round to f32), so two
    rounds equal the one-shot f64 oracle within 1e-15 and JAX's image
    within 1e-6 (5.6e-8 measured). A checkpoint keeps the double sum and
    resumes."""
    cfg = RenderConfig(scene_id=2, width=24, height=16, samples=4, bounces=4,
                       impl="oracle", dtype="float64")
    s = build_scene(2, dtype=torch.float64, device="cpu")
    cam = CameraConfig.reference_default(dtype=torch.float64)
    path = str(tmp_path / "render64")
    img = ck.render_incremental(s, cam, cfg, samples_per_round=2,
                                checkpoint_path=path)
    assert img.dtype == np.float64 and img.shape == (16, 24, 3)
    one = tracer.render(s, cam, 24, 16, 4, 4, dtype=torch.float64)
    np.testing.assert_allclose(img, one.numpy(), rtol=0, atol=1e-15)
    np.testing.assert_allclose(img, _jax_incremental("float64"), rtol=0,
                               atol=1e-6)
    acc, done = ck.load_checkpoint(path, cfg)
    assert acc.dtype == np.float64 and done == 4
    part = tracer.render(s, cam, 24, 16, 2, 4, dtype=torch.float64,
                         accumulate_only=True)
    ck.save_checkpoint(path, part.numpy(), 2, cfg)
    resumed = ck.render_incremental(s, cam, cfg, samples_per_round=1,
                                    checkpoint_path=path)
    np.testing.assert_allclose(resumed, img, rtol=0, atol=1e-15)


@pytest.mark.parametrize("impl,layout", [("kernel", "packed"),
                                         ("stream", "vmem")])
def test_render_incremental_packed_takes_stream_kernel(tmp_path, monkeypatch,
                                                        impl, layout):
    """``impl='kernel', layout='packed'`` and ``impl='stream'`` render each
    round on the stream kernel (kernel 4, ``sample_offset`` and raw sums),
    as make_renderer routes them: rounds add up to make_renderer's single
    pass, a resumed render too, and the image is JAX's
    render_incremental's under the cross-framework gate (at this shape 5
    of 1152 components take another path after a knife-edge bounce under
    XLA's fused multiply-adds, as the kernel's image against JAX's oracle
    does). With legacy_sky it raises, as the stream renderer does."""
    from raytracingincuda_torch.ops import stream_kernel
    from raytracingincuda_torch.utils import ppm

    calls = []
    real = stream_kernel.render_stream
    monkeypatch.setattr(stream_kernel, "render_stream",
                        lambda *a, **k: calls.append(k.get("sample_offset"))
                        or real(*a, **k))
    cfg = RenderConfig(scene_id=2, width=24, height=16, samples=4, bounces=4,
                       impl=impl, layout=layout)
    s, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    img = ck.render_incremental(s, cam, cfg, samples_per_round=2)
    assert calls == [0, 2]
    assert img.dtype == np.float32 and img.shape == (16, 24, 3)
    one = make_renderer(cfg, "cpu")(s, cam)
    # the sum of [0, 2) + [2, 4) in another order than [0, 4)
    np.testing.assert_allclose(img, one.numpy(), rtol=0, atol=1e-6)
    want = _jax_incremental("float32")
    stats = ppm.diff_stats(img, ppm.quantize(want))
    assert ppm.passes_cross_framework_gate(stats), stats
    path = str(tmp_path / "packed")
    ck.render_incremental(s, cam, dataclasses.replace(cfg, samples=2),
                          checkpoint_path=path)
    acc, done = ck.load_checkpoint(path, dataclasses.replace(cfg, samples=2))
    ck.save_checkpoint(path, acc, done, cfg)
    resumed = ck.render_incremental(s, cam, cfg, checkpoint_path=path,
                                    samples_per_round=1)
    np.testing.assert_allclose(resumed, img, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="legacy_sky"):
        ck.render_incremental(s, cam, dataclasses.replace(
            cfg, legacy_sky=True))


def test_render_incremental_adaptive_takes_regen_kernel(monkeypatch):
    """``impl='adaptive'`` renders uniform rounds (a budget does not split
    into rounds; JAX renders them uniformly on its oracle) on the kernel
    its renderer takes at this slot count: kernel 1 with the scene staged
    (layout 'vmem', whatever the config's), each round at its offset, and
    the image equals impl='kernel''s in rounds."""
    calls = []
    real = rk.render_kernel
    monkeypatch.setattr(rk, "render_kernel", lambda *a, **k: calls.append(
        (k["sample_offset"], k["layout"])) or real(*a, **k))
    s, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    cfg = RenderConfig(scene_id=2, width=W, height=H, samples=4, bounces=4,
                       impl="adaptive", layout="packed", legacy_sky=True)
    img = ck.render_incremental(s, cam, cfg, samples_per_round=2)
    assert calls == [(0, "vmem"), (2, "vmem")]
    want = ck.render_incremental(s, cam, dataclasses.replace(
        cfg, impl="kernel", layout="vmem"), samples_per_round=2)
    np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("layout", ["vmem", "hbm"])
def test_render_incremental_float64_kernel_renders_in_rounds(tmp_path,
                                                             monkeypatch,
                                                             layout):
    """A float64 config with impl='kernel' renders each round on the f64
    kernel (its plain version here) at the round's ``sample_offset``,
    never on the oracle: the sum and its checkpoint stay double, two
    rounds equal make_renderer's one pass within 1e-12, and a render
    resumed from the first round's checkpoint equals the uninterrupted
    one bit for bit."""
    from raytracingincuda_torch.ops import f64_kernel as fk

    calls = []
    real = fk._f64
    monkeypatch.setattr(fk, "_f64", lambda *a, **k: calls.append(
        (k["sample_offset"], k["layout"])) or real(*a, **k))
    monkeypatch.setattr(tracer, "render", lambda *a, **k: pytest.fail(
        "a float64 kernel round ran the oracle"))
    cfg = RenderConfig(scene_id=2, width=W, height=H, samples=4, bounces=4,
                       impl="kernel", layout=layout, dtype="float64")
    s, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    path = str(tmp_path / "render64")
    img = ck.render_incremental(s, cam, cfg, samples_per_round=2,
                                checkpoint_path=path)
    assert calls == [(0, layout), (2, layout)]
    assert img.dtype == np.float64 and img.shape == (H, W, 3)
    acc, done = ck.load_checkpoint(path, cfg)
    assert acc.dtype == np.float64 and done == 4
    one = make_renderer(cfg, "cpu")(s, cam)
    np.testing.assert_allclose(img, one.numpy(), rtol=0, atol=1e-12)
    first = fk.render_f64(s, cam, W, H, 2, 4, layout=layout,
                          accumulate_only=True)
    ck.save_checkpoint(path, first.numpy(), 2, cfg)
    calls.clear()
    resumed = ck.render_incremental(s, cam, cfg, samples_per_round=2,
                                    checkpoint_path=path)
    assert calls == [(2, layout)]
    np.testing.assert_array_equal(resumed, img)


def _setup():
    s = build_scene(2, pad_to_multiple=64, device="cpu")
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
