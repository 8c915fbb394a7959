"""Double precision through the oracle: the f64 image and its gradients.

``tracer.render(dtype=torch.float64)`` is the port's counterpart of the
JAX package's native-f64 oracle (``tracer.render(dtype=jnp.float64)``,
unpinned: its samplers' trig and sqrt run in double). The inputs are JAX
scene 2 (``tiny_scene``'s build) and the reference camera, carried across
with ``models/convert.py`` and cast to float64 on both sides. JAX runs
with x64 on only inside each test (``try``/``finally``), since xdist
workers share the process with the JAX tests. The file imports JAX only
inside the CPU tests: its ``cuda`` test runs on the card with
``--noconftest``, where there is no JAX.

Measured agreement (this file's shapes, on the CPU), and the tolerance
each test states:
  * the f64 samplers (``ops/rng.py`` at float64) equal JAX's bit for bit;
    float64 sin/cos equal JAX's on all of 10^6 sampler angles;
  * the image: within 4.43e-13 of JAX's, 84% of components equal (XLA's
    f64 rsqrt is an estimate within 2 ulp of ``1 / sqrt``); tolerance
    atol 1e-12;
  * the gradients against ``jax.grad``: within 1.5e-9 of each leaf's
    largest entry (the camera's lookfrom.z, largest 2.0e-6), and 2.8e-19
    on vup.y, whose gradient is rounding noise (5.4e-20); tolerance 1e-8
    of the leaf's largest entry plus 1e-15;
  * against f64 central differences: JAX's own tolerances
    (``tests/test_df64.py::test_f64_oracle_gradients_match_fd``);
  * one carried Adam step: see the test.
"""
import os

import numpy as np
import pytest
import torch

from raytracingincuda_torch import cli
from raytracingincuda_torch.config import RenderConfig
from raytracingincuda_torch.models.camera import config_leaves
from raytracingincuda_torch.models.convert import (camera_config_from_numpy,
                                                   scene_from_numpy,
                                                   train_state_from_numpy)
from raytracingincuda_torch.models.scene import (Scene, param_leaves,
                                                 params_from_leaves)
from raytracingincuda_torch.ops import f32math
from raytracingincuda_torch.ops import grad as tgrad
from raytracingincuda_torch.ops import rng as trng
from raytracingincuda_torch.ops import tracer as ttr
from raytracingincuda_torch.render_api import make_renderer
from raytracingincuda_torch.utils import checkpoint, ppm

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

F64 = torch.float64
# JAX's own FD shape (tests/test_df64.py:227)
W, H, SPP, DEPTH = 24, 16, 2, 4
IMG_ATOL = 1e-12
GRAD_FRAC, GRAD_ATOL = 1e-8, 1e-15


class _x64:
    """jax_enable_x64 on inside the block only."""

    def __enter__(self):
        import jax

        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        import jax

        jax.config.update("jax_enable_x64", False)


def _leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _f64_np(arrays):
    return [a.astype(np.float64) if a.dtype == np.float32 else a
            for a in arrays]


def _cast64(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


@pytest.fixture(scope="module")
def carried(tiny_scene, default_camera):
    """(port scene, port camera) in float64, from the JAX leaves."""
    return (scene_from_numpy(_f64_np(_leaves(tiny_scene)), device="cpu"),
            camera_config_from_numpy(_f64_np(_leaves(default_camera))))


def _target():
    return np.random.default_rng(3).uniform(0.0, 1.0, (H, W, 3))


def _assert_grads_close(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.float64, (what, k, g.dtype)
        assert np.isfinite(g).all(), (what, k)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_FRAC * scale + GRAD_ATOL,
                                   err_msg=f"{what} leaf {k}")


def test_f64_recipes_exact_and_differentiable():
    """float64 sqrt is numpy's (correctly rounded) with JAX's derivative
    0.5 / sqrt(x); rsqrt is 1 / sqrt; sin/cos are numpy's, equal to JAX's
    float64 ones on the samplers' angles; f32 inputs keep their f32
    recipes."""
    rng = np.random.default_rng(7)
    x = rng.uniform(1e-6, 4.0, 100_000)
    t = torch.from_numpy(x).requires_grad_(True)
    out = f32math.sqrt(t)
    assert out.dtype == F64
    np.testing.assert_array_equal(out.detach().numpy(), np.sqrt(x))
    (g,) = torch.autograd.grad(out.sum(), t)
    np.testing.assert_array_equal(g.numpy(), 0.5 / np.sqrt(x))
    np.testing.assert_array_equal(f32math.rsqrt(torch.from_numpy(x)).numpy(),
                                  1.0 / np.sqrt(x))
    import jax.numpy as jnp

    ang = (2.0 * np.pi) * (rng.integers(0, 1 << 23, 100_000)
                           / float(1 << 23))
    with _x64():
        want_s = np.asarray(jnp.sin(jnp.asarray(ang)))
        want_c = np.asarray(jnp.cos(jnp.asarray(ang)))
    np.testing.assert_array_equal(f32math.sin(torch.from_numpy(ang)).numpy(),
                                  want_s)
    np.testing.assert_array_equal(f32math.cos(torch.from_numpy(ang)).numpy(),
                                  want_c)
    assert f32math.sqrt(torch.ones(3)).dtype == torch.float32
    with pytest.raises(ValueError, match="gradient"):
        f32math.sin(torch.from_numpy(ang).requires_grad_(True))


def test_f64_samplers_equal_jax():
    """The unpinned samplers at float64: the f32 mantissa fill cast to
    double, then the trig and sqrt in double, as JAX's rng.py."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.ops import rng as jrng

    ids = np.arange(4096, dtype=np.uint32)
    key = trng.key_from_seed(1227)
    got_v = trng.random_unit_vector(key, torch.from_numpy(ids.astype(
        np.int64)), 3, 2, trng.DRAW_SCATTER, F64)
    got_d = trng.random_in_unit_disk(key, torch.from_numpy(ids.astype(
        np.int64)), 5, F64)
    got_u = trng.uniform2(key, torch.from_numpy(ids.astype(np.int64)), 1, 0,
                          trng.DRAW_JITTER, F64)
    with _x64():
        jkey = jrng.key_from_seed(1227)
        jids = jnp.asarray(ids)
        want_v = jrng.random_unit_vector(jkey, jids, 3, 2, jrng.DRAW_SCATTER,
                                         jnp.float64)
        want_d = jrng.random_in_unit_disk(jkey, jids, 5, jnp.float64)
        want_u = jrng.uniform2(jkey, jids, 1, 0, jrng.DRAW_JITTER,
                               jnp.float64)
        want = [np.asarray(x) for x in (*want_v, *want_d, *want_u)]
    for g, w in zip((*got_v, *got_d, *got_u), want):
        assert g.dtype == F64 and w.dtype == np.float64
        np.testing.assert_array_equal(g.numpy(), w)


def test_f64_oracle_image_matches_jax(tiny_scene, default_camera, carried):
    """The f64 oracle against JAX's unpinned f64 oracle (atol 1e-12);
    ``make_renderer(impl='oracle', dtype='float64')`` on the f32 scene
    casts it exactly, so its image is the f64 scene's, bit for bit."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.ops import tracer as jtr

    scene, cam = carried
    got = ttr.render(scene, cam, W, H, SPP, DEPTH, dtype=F64)
    assert got.dtype == F64 and got.shape == (H, W, 3)
    with _x64():
        want = np.asarray(jtr.render(_cast64(tiny_scene),
                                     _cast64(default_camera), W, H, SPP,
                                     DEPTH, dtype=jnp.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMG_ATOL)
    cfg = RenderConfig(scene_id=2, width=W, height=H, samples=SPP,
                       bounces=DEPTH, impl="oracle", dtype="float64")
    f32_scene = scene_from_numpy(_leaves(tiny_scene), device="cpu")
    img = make_renderer(cfg, "cpu")(f32_scene, camera_config_from_numpy(
        _leaves(default_camera)))
    assert img.dtype == F64 and img.shape == (H, W, 3)
    assert torch.equal(img, got)


def test_f64_render_grads_match_jax_grad(tiny_scene, default_camera,
                                         carried):
    """``render_grads(dtype=float64)`` against ``jax.grad`` through the
    JAX f64 oracle (``grad.render_grads(dtype=jnp.float64)``): the loss to
    1e-14 and every scene and camera leaf within 1e-8 of its largest
    entry plus 1e-15."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.ops import grad as jgrad

    scene, cam = carried
    target = _target()
    loss, (gp, gc) = tgrad.render_grads(scene, cam, torch.from_numpy(target),
                                        W, H, SPP, DEPTH, dtype=F64)
    with _x64():
        jloss, (jgp, jgc) = jgrad.render_grads(
            _cast64(tiny_scene), _cast64(default_camera),
            jnp.asarray(target), W, H, SPP, DEPTH, dtype=jnp.float64)
        want = _leaves((jgp, jgc))
        jloss = float(jloss)
    assert loss.dtype == F64
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-14)
    _assert_grads_close([*param_leaves(gp), *config_leaves(gc)], want,
                        "render_grads")


def _check_fd(scene, cam):
    """Autograd through the f64 oracle against f64 central differences at
    h=1e-6 (no silhouette is crossed at this shape): albedo and vfov to
    rtol 1e-4 / atol 1e-10, radius to rtol 1e-3 / atol 1e-9, on the
    largest-|g| component, as ``tests/test_df64.py`` holds JAX's."""
    wimg = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (H, W, 3))).to(scene.mat_type.device)
    h = 1e-6

    def loss(sc, cm):
        img = ttr.render(sc, cm, W, H, SPP, DEPTH, dtype=F64, gamma=False)
        return (wimg * img).sum()

    def with_leaf(k, v):
        leaves = param_leaves(scene.params)
        leaves[k] = v
        return Scene(params_from_leaves(leaves), scene.mat_type,
                     scene.active)

    for k, rtol, atol in ((4, 1e-4, 1e-10), (3, 1e-3, 1e-9)):  # albedo.x, r
        x0 = param_leaves(scene.params)[k]
        x = x0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(with_leaf(k, x), cam), x)
        assert g.dtype == F64 and torch.isfinite(g).all()
        i = int(g.abs().argmax())
        e = torch.zeros_like(x0)
        e[i] = h
        fd = (loss(with_leaf(k, x0 + e), cam)
              - loss(with_leaf(k, x0 - e), cam)) / (2 * h)
        np.testing.assert_allclose(float(g[i]), float(fd), rtol=rtol,
                                   atol=atol)
    v = cam.vfov.clone().requires_grad_(True)
    (gv,) = torch.autograd.grad(loss(scene, cam._replace(vfov=v)), v)
    fd = (loss(scene, cam._replace(vfov=cam.vfov + h))
          - loss(scene, cam._replace(vfov=cam.vfov - h))) / (2 * h)
    np.testing.assert_allclose(float(gv), float(fd), rtol=1e-4, atol=1e-10)


def test_f64_oracle_gradients_match_fd(carried):
    """The port's ``tests/test_df64.py::test_f64_oracle_gradients_match_fd``
    (``_check_fd``) on the carried scene."""
    _check_fd(*carried)


def _port_scene2_f64(device):
    """JAX's ``tiny_scene`` (scene 2 in slots of 64) and the reference
    camera from the port's own builders, in float64 on ``device``."""
    from raytracingincuda_torch.models.camera import (CameraConfig,
                                                      config_from_leaves)
    from raytracingincuda_torch.models.scene import build_scene

    s = build_scene(2, pad_to_multiple=64, device=device)
    scene = Scene(params_from_leaves([t.double() for t in
                                      param_leaves(s.params)]),
                  s.mat_type, s.active)
    cam = config_from_leaves([t.double().to(device) for t in config_leaves(
        CameraConfig.reference_default())])
    return scene, cam


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_f64_oracle_on_card(cuda):
    """The f64 oracle on the card: the image within 1e-12 of the CPU's
    (the card's double sin/cos are not glibc's), gradients within 1e-8 of
    each leaf's largest entry plus 1e-15 of the CPU's, and against f64
    central differences as on the CPU."""
    card = _port_scene2_f64(cuda)
    host = _port_scene2_f64("cpu")
    img = ttr.render(*card, W, H, SPP, DEPTH, dtype=F64)
    want = ttr.render(*host, W, H, SPP, DEPTH, dtype=F64)
    assert img.dtype == F64 and img.device.type == "cuda"
    np.testing.assert_allclose(img.cpu().numpy(), want.numpy(), rtol=0,
                               atol=IMG_ATOL)
    target = torch.from_numpy(_target())
    _, (gp, gc) = tgrad.render_grads(*card, target.to(cuda), W, H, SPP,
                                     DEPTH, dtype=F64)
    _, (hp, hc) = tgrad.render_grads(*host, target, W, H, SPP, DEPTH,
                                     dtype=F64)
    _assert_grads_close([t.cpu() for t in [*param_leaves(gp),
                                           *config_leaves(gc)]],
                        [t.numpy() for t in [*param_leaves(hp),
                                             *config_leaves(hc)]], "card")
    _check_fd(*card)


def test_f64_carried_train_step_matches_jax(tiny_scene, default_camera,
                                            tmp_path):
    """A JAX f64 TrainState after one oracle Adam step, carried into the
    port, then one more ``make_train_step(impl='oracle',
    dtype=float64)`` step on each side: the loss to 1e-14, the new
    parameters to 1e-12 absolute, the moments to 1e-8 of each leaf's
    largest entry plus 1e-15 (their gradients agree as in the test
    above), count and step; the state is float64 throughout and a
    checkpoint round-trips it bit for bit."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.ops import grad as jgrad

    target = _target()
    with _x64():
        js, jc = _cast64(tiny_scene), _cast64(default_camera)
        init_fn, step_fn = jgrad.make_train_step(W, H, SPP, DEPTH,
                                                 learning_rate=1e-2,
                                                 dtype=jnp.float64)
        state = init_fn(js.params)
        jt = jnp.asarray(target)
        state, _ = step_fn(state, jc, js.mat_type, js.active, jt)
        nxt, jloss = step_fn(state, jc, js.mat_type, js.active, jt)
        carried_np, want_np = _leaves(state), _leaves(nxt)
        jloss = float(jloss)
    carried_state = train_state_from_numpy(carried_np, device="cpu")
    want = train_state_from_numpy(want_np, device="cpu")
    scene = scene_from_numpy(_f64_np(_leaves(tiny_scene)), device="cpu")
    cam = camera_config_from_numpy(_f64_np(_leaves(default_camera)))
    _, step = tgrad.make_train_step(W, H, SPP, DEPTH, learning_rate=1e-2,
                                    impl="oracle", dtype=F64)
    new, loss = step(carried_state, cam, scene.mat_type, scene.active,
                     torch.from_numpy(target))
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-14)
    for g, w in zip(param_leaves(new.params), param_leaves(want.params)):
        assert g.dtype == F64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12)
    for name in ("mu", "nu"):
        _assert_grads_close(param_leaves(getattr(new.opt_state, name)),
                            [w.numpy() for w in param_leaves(
                                getattr(want.opt_state, name))], name)
    assert int(new.opt_state.count) == int(want.opt_state.count) == 2
    assert int(new.step) == int(want.step) == 2
    path = str(tmp_path / "f64_state")
    checkpoint.save_train_state(path, new, token="f64")
    back = checkpoint.load_train_state(path, new, token="f64")
    for a, b in zip(tgrad.train_state_leaves(back),
                    tgrad.train_state_leaves(new)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cli_oracle_float64_writes_double_file(tmp_path, capsys):
    """``--impl oracle --dtype float64`` writes the 'double' file name,
    from the f64 oracle's image of the scene and camera built in
    float64."""
    rc = cli.main(["--scene_id", "2", "--width", "20", "--height", "12",
                   "--samples", "2", "--bounces", "3", "--device", "cpu",
                   "--impl", "oracle", "--dtype", "float64", "--no-warmup",
                   "--outdir", str(tmp_path)])
    assert rc == 0
    cfg = RenderConfig(scene_id=2, width=20, height=12, samples=2, bounces=3,
                       impl="oracle", dtype="float64")
    name = cfg.output_filename()
    assert name.startswith("const_double_scene2_")
    from raytracingincuda_torch.models.camera import CameraConfig
    from raytracingincuda_torch.models.scene import build_scene

    img = make_renderer(cfg, "cpu")(build_scene(2, dtype=F64, device="cpu"),
                                    CameraConfig.reference_default(F64))
    ppm.write_ppm(str(tmp_path / "want.ppm"), img.numpy())
    assert ((tmp_path / name).read_bytes()
            == (tmp_path / "want.ppm").read_bytes())
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line.split(",")) == 2


@pytest.mark.parametrize("kw", [dict(rr_start=2), dict(legacy_sky=True),
                                dict(layout="packed"),
                                dict(layout="hbm", rr_start=2)],
                         ids=["rr2", "legacy_sky", "packed", "hbm-rr2"])
def test_f64_oracle_scope_takes_every_estimator(kw, carried):
    """``dtype='float64'`` with ``impl='oracle'`` takes ``rr_start``,
    ``legacy_sky`` and every layout, as JAX's native-f64 oracle does, and
    its renderer is ``tracer.render(dtype=float64)`` bit for bit (the
    oracle ignores the layout); the f64 kernel keeps the df64 kernel's
    scope and refuses the same config."""
    scene, cam = carried
    cfg = RenderConfig(scene_id=2, width=W, height=H, samples=SPP,
                       bounces=DEPTH, impl="oracle", dtype="float64", **kw)
    img = make_renderer(cfg, "cpu")(scene, cam)
    want = ttr.render(scene, cam, W, H, SPP, DEPTH, dtype=F64,
                      rr_start=kw.get("rr_start"),
                      legacy_sky=kw.get("legacy_sky", False))
    assert img.dtype == F64 and torch.equal(img, want)
    with pytest.raises(ValueError, match="impl='kernel'"):
        RenderConfig(scene_id=2, impl="kernel", dtype="float64", **kw)
    for impl in ("adaptive", "stream"):
        with pytest.raises(ValueError, match="no f64 path"):
            RenderConfig(scene_id=2, impl=impl, dtype="float64",
                         samples=4, **kw)


def test_f64_oracle_grad_entry_points_take_rr_start(carried):
    """``grad.make_loss_fn`` and ``make_train_step`` at float64 through
    the oracle take ``rr_start``, as JAX's do: the loss is the mean
    squared error of ``tracer.render(dtype=float64, rr_start=2,
    gamma=False)``, its gradient is float64 and finite, and a train step
    returns that loss. Neither package's loss takes ``legacy_sky``."""
    import inspect

    from raytracingincuda_tpu.ops import grad as jgrad

    scene, cam = carried
    target = torch.from_numpy(_target())
    loss_fn = tgrad.make_loss_fn(W, H, SPP, DEPTH, dtype=F64, rr_start=2)
    params = params_from_leaves([x.detach().requires_grad_()
                                 for x in param_leaves(scene.params)])
    loss = loss_fn(params, cam, scene.mat_type, scene.active, target)
    img = ttr.render(scene, cam, W, H, SPP, DEPTH, dtype=F64, rr_start=2,
                     gamma=False)
    assert loss.dtype == F64
    assert float(loss.detach()) == float(torch.mean((img - target) ** 2))
    loss.backward()
    for x in param_leaves(params):
        assert x.grad.dtype == F64 and torch.isfinite(x.grad).all()
    init_fn, step_fn = tgrad.make_train_step(W, H, SPP, DEPTH, impl="oracle",
                                             dtype=F64, rr_start=2)
    _, step_loss = step_fn(init_fn(scene.params), cam, scene.mat_type,
                           scene.active, target)
    assert float(step_loss) == float(loss.detach())
    for fn in (tgrad.make_loss_fn, jgrad.make_loss_fn):
        assert "rr_start" in inspect.signature(fn).parameters
        assert "legacy_sky" not in inspect.signature(fn).parameters


def test_cli_f64_oracle_builds_double_scene(tmp_path, capsys, monkeypatch):
    """``--dtype float64 --impl oracle`` builds the scene and camera in
    float64, as JAX's CLI does on the CPU (scene 1's small spheres are not
    exact in float32), and writes JAX's CLI's PPM bytes at scene 1,
    48x32, 2 spp, 4 bounces; ``--impl kernel`` keeps the f32 scene that
    the f64 kernel packs, as JAX's df64 path does."""
    from raytracingincuda_torch import render_api
    from raytracingincuda_tpu import cli as jax_cli

    seen = []
    real = render_api.make_renderer

    def spy(cfg, *a, **k):
        r = real(cfg, *a, **k)

        def renderer(scene, cam):
            seen.append((scene.params.radius.dtype, cam.vfov.dtype))
            return r(scene, cam)
        return renderer

    monkeypatch.setattr(render_api, "make_renderer", spy)
    flags = ["--scene_id", "1", "--width", "48", "--height", "32",
             "--samples", "2", "--bounces", "4", "--dtype", "float64",
             "--no-warmup"]
    for impl, out in (("oracle", "port"), ("kernel", "kernel")):
        os.makedirs(tmp_path / out)
        assert cli.main([*flags, "--impl", impl, "--device", "cpu",
                         "--outdir", str(tmp_path / out)]) == 0
    assert seen == [(F64, F64), (torch.float32, torch.float32)]
    os.makedirs(tmp_path / "jax")
    with _x64():
        assert jax_cli.main([*flags, "--impl", "oracle", "--devices", "1",
                             "--outdir", str(tmp_path / "jax")]) == 0
    capsys.readouterr()
    name = "const_double_scene1_48x32_2samples_4bounces_8threadsPerBlockRow.ppm"
    assert os.listdir(tmp_path / "port") == [name]
    assert ((tmp_path / "port" / name).read_bytes()
            == (tmp_path / "jax" / name).read_bytes())
