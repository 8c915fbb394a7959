"""Training streamed scenes: ``grad.make_stream_train`` (fused and
two-program), the fused stream step's four losses, and the fused kernel
on the card.

A JAX ``TrainState`` after one ``make_stream_train`` step (interpret
mode) is carried into the port with ``models/convert.py``; one more step
on each side must agree as ``test_torch_grad.py``'s carried oracle step
does (with geometry trainable, against the JAX oracle's step run op by
op). The ``cuda`` test holds the fused kernel to its plain version and
skips without a card; JAX is imported inside the tests that use it, so
that ``pytest --noconftest -m cuda`` runs this file on a machine without
JAX.
"""
import os
import sys

import numpy as np
import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.scene import build_random_scene, param_leaves
from raytracingincuda_torch.ops import grad as tgrad
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import stream_kernel as sk
from raytracingincuda_torch.ops import stream_train_kernel as stk
from raytracingincuda_torch.ops import train_kernel as tk
from raytracingincuda_torch.utils import trace

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

W, H, SPP, DEPTH = 24, 16, 2, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def _close(got, want, frac, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


@pytest.fixture(scope="module")
def small():
    """Ground, a lambertian and a metal sphere, padded to 8 slots:
    (JAX scene, port scene)."""
    import jax

    from helpers import scene_from_spheres
    from raytracingincuda_torch.models.convert import scene_from_numpy
    from raytracingincuda_tpu.models.scene import LAMBERTIAN, METAL

    js = scene_from_spheres([
        dict(center=(0, -1000, 0), radius=1000.0, mat=LAMBERTIAN,
             albedo=(0.5, 0.5, 0.5)),
        dict(center=(0, 1, 0), radius=1.0, mat=LAMBERTIAN,
             albedo=(0.8, 0.2, 0.1)),
        dict(center=(2, 1, 0), radius=1.0, mat=METAL,
             albedo=(0.7, 0.6, 0.5), fuzz=0.1),
    ], pad_to=8)
    return js, scene_from_numpy([np.asarray(x) for x in
                                 jax.tree_util.tree_leaves(js)], device="cpu")


@pytest.fixture(scope="module")
def target():
    return np.random.default_rng(5).uniform(0.0, 1.0, (H, W, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_carried(small, target):
    """``jax_carried(fused)``: a JAX TrainState after one stream step
    (albedo and fuzz trainable) and the next JAX step from it: (state,
    next state, loss), each computed once."""
    cache = {}

    def get(fused):
        if fused not in cache:
            import jax.numpy as jnp

            from raytracingincuda_tpu.models.camera import CameraConfig as JCam
            from raytracingincuda_tpu.models.scene import (
                SceneParams as JParams)
            from raytracingincuda_tpu.ops.grad import make_stream_train
            from raytracingincuda_tpu.ops.pallas_stream import (
                prepare_stream_scene)
            from raytracingincuda_tpu.ops.vec import Vec3 as JV

            js, _ = small
            jmask = JParams(center=JV(False, False, False), radius=False,
                            albedo=JV(True, True, True), fuzz=True, ior=False)
            jcam, jtgt = JCam.reference_default(), jnp.asarray(target)
            init_fn, step_fn = make_stream_train(
                prepare_stream_scene(js, block=32), W, H, SPP, DEPTH,
                fused=fused, trainable=jmask)
            state, _ = step_fn(init_fn(js.params), jcam, js.mat_type,
                               js.active, jtgt)
            nxt, jloss = step_fn(state, jcam, js.mat_type, js.active, jtgt)
            cache[fused] = state, nxt, jloss
        return cache[fused]

    return get


def _albedo_fuzz_mask():
    from raytracingincuda_torch.models.scene import SceneParams
    from raytracingincuda_torch.ops.vec import Vec3 as TV

    return SceneParams(center=TV(False, False, False), radius=False,
                       albedo=TV(True, True, True), fuzz=True, ior=False)


def _carry(s, trainable=None):
    import jax

    from raytracingincuda_torch.models.convert import train_state_from_numpy

    return train_state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(s)],
        trainable=trainable, device="cpu")


def _hold_to_jax(new, want, carried, tloss, jloss, tmask):
    """The carried test's bars: the loss to 1e-5, each trainable parameter
    within 1e-6, the frozen ones unchanged, moments to 2e-3 of each leaf's
    largest entry, count and step."""
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    trainable = [bool(t) for t in param_leaves(tmask)]
    for k, (g, w, c) in enumerate(zip(param_leaves(new.params),
                                      param_leaves(want.params),
                                      param_leaves(carried.params))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"param {k}")
        if not trainable[k]:
            assert torch.equal(g, c), f"frozen leaf {k} moved"
    for name in ("mu", "nu"):
        for k, (g, w) in enumerate(zip(
                param_leaves(getattr(new.opt_state, name)),
                param_leaves(getattr(want.opt_state, name)))):
            _close(g, w.numpy(), 2e-3, f"{name} leaf {k}")
    assert int(new.opt_state.count) == int(want.opt_state.count) == 2
    assert int(new.step) == int(want.step) == 2


@pytest.mark.parametrize("fused", [True, False])
def test_carried_stream_train_step_matches_jax(small, target, jax_carried,
                                               fused):
    """A JAX TrainState after one stream step (albedo and fuzz trainable),
    carried into the port, then one more step on each side: the loss to
    1e-5, each trainable parameter within 1e-6 (as the carried oracle
    step), the frozen ones unchanged, moments to 2e-3 of each leaf's
    largest entry, count and step. Geometry is frozen here: on this
    24x16 image one knife-edge metal bounce, sent elsewhere by a 1-ulp
    rsqrt difference, moves a centre's gradient by 0.2% (measured), and
    Adam's normalised step turns that into 1e-5 of the parameter; the
    geometry step is held to the JAX oracle in
    test_carried_stream_step_trains_geometry_as_jax."""
    js, ts = small
    tmask = _albedo_fuzz_mask()
    state, nxt, jloss = jax_carried(fused)
    carried = _carry(state, tmask)
    _, step_t = tgrad.make_stream_train(
        sk.prepare_stream_scene(ts, block=32), W, H, SPP, DEPTH, fused=fused,
        trainable=tmask)
    new, tloss = step_t(carried, TCam.reference_default(), ts.mat_type,
                        ts.active, torch.from_numpy(target))
    _hold_to_jax(new, _carry(nxt, tmask), carried, tloss, jloss, tmask)


@pytest.mark.parametrize("fused", [True, False])
def test_carried_stream_train_step_in_record_windows(small, target,
                                                     jax_carried, fused):
    """The carried step with a record budget of one sample of 128 lanes (6
    windows: 3 chunks of lanes a sample) equals the one-window step within
    1e-6 (the windows' sums add in another order) and holds to the carried
    JAX step as test_carried_stream_train_step_matches_jax does."""
    js, ts = small
    tmask = _albedo_fuzz_mask()
    budget = rk.PAD * DEPTH * stk.PLAN_BYTES
    assert len(stk.plan_records(W * H, SPP, DEPTH, budget)) == 6
    state, nxt, jloss = jax_carried(fused)
    carried = _carry(state, tmask)
    stream = sk.prepare_stream_scene(ts, block=32)
    steps = {b: tgrad.make_stream_train(stream, W, H, SPP, DEPTH, fused=fused,
                                        trainable=tmask, budget=b)[1]
             for b in (stk.RECORD_BUDGET, budget)}
    args = (TCam.reference_default(), ts.mat_type, ts.active,
            torch.from_numpy(target))
    (one, one_loss), (new, tloss) = (steps[b](carried, *args)
                                     for b in (stk.RECORD_BUDGET, budget))
    np.testing.assert_allclose(float(tloss), float(one_loss), rtol=1e-6)
    for k, (g, w) in enumerate(zip(param_leaves(new.params),
                                   param_leaves(one.params))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"param {k}")
    _hold_to_jax(new, _carry(nxt, tmask), carried, tloss, jloss, tmask)


@pytest.mark.parametrize("lanes,samples,depth,budget,n_windows", [
    (640 * 384, 100, 25, stk.RECORD_BUDGET, 25),  # refused before
    (640 * 384, 4, 10, stk.RECORD_BUDGET, 1),     # chip_smoke.py phase 12
    (1280 * 768, 3, 256, stk.RECORD_BUDGET, 27),  # a sample does not fit
    (24 * 16, 2, 3, 128 * 3 * stk.PLAN_BYTES, 6),
    (5 * 128, 3, 4, 2 * 128 * 4 * stk.PLAN_BYTES, 9),
    (5 * 128, 7, 4, 5 * 128 * 4 * stk.PLAN_BYTES * 3, 3),
])
def test_plan_records_windows_cover_within_budget(lanes, samples, depth,
                                                  budget, n_windows):
    """Every (lane, sample) falls in exactly one window, a window's records
    and their sort (PLAN_BYTES, 76 bytes a record) stay within the budget,
    lane chunks are whole blocks of 128 and appear only where one sample of
    every lane does not fit. At 640x384, 100 spp and 25 bounces a sample's
    records take 245.76 MB and 466.944 MB with their sort, so 2 GiB holds
    4 samples: 25 windows."""
    plan = stk.plan_records(lanes, samples, depth, budget)
    assert len(plan) == n_windows
    covered = np.zeros((samples, lanes), np.int8)
    for w in plan:
        covered[w.sample0:w.sample0 + w.samples,
                w.lane0:w.lane0 + w.lanes] += 1
        assert w.lanes * w.samples * depth * stk.PLAN_BYTES <= budget
        assert w.lane0 % rk.PAD == 0 and w.lanes % rk.PAD == 0
    assert (covered == 1).all()
    assert (any(w.lanes < lanes for w in plan)
            == (lanes * depth * stk.PLAN_BYTES > budget))
    if samples == 100:
        assert max(w.samples for w in plan) == 4
        assert lanes * depth * stk.RECORD_BYTES == 245_760_000
        assert lanes * depth * stk.PLAN_BYTES == 466_944_000


def test_plan_records_refusals():
    with pytest.raises(ValueError, match="multiple"):
        stk.plan_records(100, 1, 4)
    with pytest.raises(ValueError, match="budget"):
        stk.plan_records(rk.PAD, 1, 256, budget=rk.PAD * 256 * stk.PLAN_BYTES - 1)
    assert stk.RECORD_BUDGET == tk.PARK_BUDGET == 2 << 30


@pytest.fixture(scope="module")
def oracle_step(small, target):
    """On ``small``, a JAX TrainState after one ``make_stream_train`` step
    with every parameter trainable, and the JAX oracle's next step from it
    run op by op: (carried state, next state, loss)."""
    import jax
    import jax.numpy as jnp

    from raytracingincuda_torch.models.convert import train_state_from_numpy
    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.ops.grad import (make_stream_train,
                                               make_train_step)
    from raytracingincuda_tpu.ops.pallas_stream import prepare_stream_scene

    js, _ = small
    jcam, jtgt = JCam.reference_default(), jnp.asarray(target)
    init_fn, step_fn = make_stream_train(prepare_stream_scene(js, block=32),
                                         W, H, SPP, DEPTH)
    state, _ = step_fn(init_fn(js.params), jcam, js.mat_type, js.active, jtgt)
    _, step_o = make_train_step(W, H, SPP, DEPTH)
    with jax.disable_jit():
        nxt, loss = step_o(state, jcam, js.mat_type, js.active, jtgt)

    def carry(s):
        return train_state_from_numpy(
            [np.asarray(x) for x in jax.tree_util.tree_leaves(s)],
            device="cpu")

    return carry(state), carry(nxt), float(loss)


@pytest.mark.parametrize("fused", [True, False])
def test_carried_stream_step_trains_geometry_as_jax(small, oracle_step,
                                                    target, fused):
    """Geometry trainable, on the same scene: a JAX stream TrainState
    carried into the port, then one stream step in the port against one
    step of the JAX oracle run op by op from the same state (the stream
    image equals the brute-force one but at ties, so the two steps are one
    function). Each parameter within 1e-6, as the carried oracle step in
    test_torch_grad.py; moments to 2e-3 of each leaf's largest entry. Run
    op by op, JAX's arithmetic is the port's, so the knife-edge metal
    bounce that the XLA-compiled stream kernel sends elsewhere goes the
    same way on both sides."""
    _, ts = small
    carried, want, jloss = oracle_step
    _, step_t = tgrad.make_stream_train(sk.prepare_stream_scene(ts, block=32),
                                        W, H, SPP, DEPTH, fused=fused)
    new, tloss = step_t(carried, TCam.reference_default(), ts.mat_type,
                        ts.active, torch.from_numpy(target))
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-5)
    moved = 0
    for k, (g, w, c) in enumerate(zip(param_leaves(new.params),
                                      param_leaves(want.params),
                                      param_leaves(carried.params))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"param {k}")
        moved += int((g != c).sum())
    assert moved >= 3 * 7, moved            # centres, radii, albedos moved
    for name in ("mu", "nu"):
        for k, (g, w) in enumerate(zip(
                param_leaves(getattr(new.opt_state, name)),
                param_leaves(getattr(want.opt_state, name)))):
            _close(g, w.numpy(), 2e-3, f"{name} leaf {k}")
    assert int(new.opt_state.count) == int(want.opt_state.count) == 2
    assert int(new.step) == int(want.step) == 2


@pytest.mark.parametrize("loss", tk.LOSSES)
def test_fused_stream_losses(loss):
    """The fused step's loss is the loss of the stream render's image (to
    1e-6), and its gradients are the two-program path's (the render's
    loss gradient through the gradient mode) to 1e-5 of the largest
    entry: summation order."""
    s = build_random_scene(60, seed=2, pad_to_multiple=32, half_extent=6.0,
                           device="cpu")
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(s, block=32)
    tgt = torch.from_numpy(np.random.default_rng(6).uniform(
        0.0, 1.0, (H, W, 3)).astype(np.float32))
    lv, d_stream, d_cam = stk.mse_train_stream(st, cam, tgt, W, H, SPP,
                                               DEPTH, rr_start=1, loss=loss,
                                               huber_delta=0.25)
    img = sk.render_stream(st, cam, W, H, SPP, DEPTH, gamma=False,
                           rr_start=1).requires_grad_(True)
    want = tgrad.image_loss(img, tgt, loss, 0.25)
    np.testing.assert_allclose(float(lv), float(want.detach()), rtol=1e-6)
    (g_img,) = torch.autograd.grad(want, img)
    two = stk.render_stream_grads(st, cam, g_img / SPP, W, H, SPP, DEPTH,
                                  rr_start=1)
    _close(d_stream, two[0].numpy(), 1e-5, "d_stream")
    _close(d_cam, two[1].numpy(), 1e-5, "d_cam_row")


def test_stream_training_entry_points():
    """make_loss_fn / make_train_step refuse impl='stream' and name
    make_stream_train; the fused and two-program steps lower the loss
    together; the VMEM train functions refuse layout='packed'."""
    s = build_random_scene(60, seed=2, pad_to_multiple=32, half_extent=6.0,
                           device="cpu")
    cam = TCam.reference_default()
    with pytest.raises(ValueError, match="make_stream_train"):
        tgrad.make_loss_fn(W, H, SPP, DEPTH, impl="stream")
    with pytest.raises(ValueError, match="make_stream_train"):
        tgrad.make_train_step(W, H, SPP, DEPTH, impl="stream")
    with pytest.raises(ValueError, match="make_stream_train"):
        tk.fused_train(s, cam, torch.zeros((H, W, 3)), W, H, SPP, DEPTH,
                       layout="packed")
    with pytest.raises(TypeError, match="Mesh"):
        tgrad.make_stream_train(sk.prepare_stream_scene(s), W, H, SPP, DEPTH,
                                mesh=object())
    st = sk.prepare_stream_scene(s, block=32)
    tgt = sk.render_stream(st, cam, W, H, SPP, DEPTH, gamma=False)
    start = s.params._replace(radius=s.params.radius * 1.2)
    losses = {}
    for fused in (True, False):
        init_fn, step_fn = tgrad.make_stream_train(st, W, H, SPP, DEPTH,
                                                   learning_rate=2e-2,
                                                   fused=fused)
        state = init_fn(start)
        losses[fused] = []
        for _ in range(3):
            state, lv = step_fn(state, cam, s.mat_type, s.active, tgt)
            losses[fused].append(float(lv))
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)
    assert losses[True][-1] < losses[True][0], losses


@pytest.mark.cuda
@pytest.mark.parametrize("loss", tk.LOSSES)
def test_fused_stream_kernel_equals_plain_version_on_card(cuda, loss):
    """The fused mode vs its plain version on the card: the image bit-equal
    (and to the stream kernel's), loss to 1e-6, gradients to 1e-4 of the
    largest entry."""
    s = build_random_scene(1000, seed=3, device=cuda)
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(s, block=64)
    ids, ii, jj, bud, _, row = rk.regen_inputs(s, cam, 64, 40, 4)
    tgt = torch.rand((3, ids.shape[0]), generator=torch.Generator()
                     .manual_seed(1)).to(cuda)
    args = (ids, ii, jj, tgt, st.scene_mat, st.bounds, row)
    kw = dict(block=64, samples=4, max_depth=6, rr_start=2,
              num_pixels=64 * 40, gamma=True, loss=loss, huber_delta=0.25)
    before = trace.counts().get("launch.stream_train", 0)
    got = stk.fused_stream_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert trace.counts().get("launch.stream_train", 0) == before + 1
    want = stk.fused_stream_reference(*args, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[1], sk.stream_kernel(
        ids, ii, jj, bud, st.scene_mat, st.bounds, row, block=64, samples=4,
        max_depth=6, rr_start=2, finalize_scale=0.25))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    _close(got[2], want[2].cpu().numpy(), 1e-4, "d_stream")
    _close(got[3], want[3].cpu().numpy(), 1e-4, "d_cam_row")


@pytest.mark.cuda
@pytest.mark.parametrize("loss", tk.LOSSES)
def test_fused_stream_kernel_in_record_windows_on_card(cuda, loss):
    """The fused mode with a budget of several windows takes the windowed
    route (the stream kernel's render, the loss block, the gradient mode a
    window at a time): its image and loss are the one-launch step's bits
    (the stream kernel's sums are kernel 5's, and the loss is summed in
    the launch's order), its gradients within 1e-4 of the largest entry of
    the one-launch step's and of the plain version in the same windows."""
    s = build_random_scene(1000, seed=3, device=cuda)
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(s, block=64)
    ids, ii, jj, _, _, row = rk.regen_inputs(s, cam, 64, 40, 4)
    tgt = torch.rand((3, ids.shape[0]), generator=torch.Generator()
                     .manual_seed(1)).to(cuda)
    args = (ids, ii, jj, tgt, st.scene_mat, st.bounds, row)
    kw = dict(block=64, samples=4, max_depth=6, rr_start=2,
              num_pixels=64 * 40, gamma=loss == "mse", loss=loss,
              huber_delta=0.25)
    budget = ids.shape[0] * 6 * stk.PLAN_BYTES   # one sample a window
    one = stk.fused_stream_kernel(*args, **kw)
    before = trace.counts()
    got = stk.fused_stream_kernel(*args, budget=budget, **kw)
    torch.cuda.synchronize()
    after = trace.counts()
    assert (after["launch.stream_train"], after["launch.stream_render"]) == (
        before.get("launch.stream_train", 0) + 4,
        before.get("launch.stream_render", 0) + 1)
    want = stk.fused_stream_reference(*args, budget=budget, **kw)
    assert torch.equal(got[1], one[1]) and torch.equal(got[0], one[0])
    for a, b, c, what in zip(got[2:], one[2:], want[2:],
                             ("d_stream", "d_cam_row")):
        _close(a, b.cpu().numpy(), 1e-4, what)
        _close(a, c.cpu().numpy(), 1e-4, what)
