"""The train kernels' module (ops/train_kernel.py): plain versions,
entry points, and the kernels on the card.

On the CPU the entry points run the kernels' plain versions
(``grad_reference``, ``fused_train_reference``); the tests hold them to
the JAX kernels in interpret mode (``render_pallas_grads`` and
``mse_train_pallas`` with the full park, one 128-lane tile), to the JAX
oracle run op by op, and to their own invariants. XLA compiles interpret
mode and fuses multiply-adds there, so a few knife-edge paths may take
another way: gradients are held to a fraction of each array's largest
entry, stated per test. The ``cuda`` tests hold each kernel to its plain
version on the card and skip without one; JAX is imported inside the
tests that use it, so that ``pytest --noconftest -m cuda`` runs this
file on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.camera import config_leaves
from raytracingincuda_torch.models.scene import build_scene, param_leaves
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import train_kernel as tk
from raytracingincuda_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

W, H, SPP, DEPTH = 16, 8, 2, 4   # one 128-lane tile


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mixed():
    """The four-sphere scene of tests/test_pallas_train.py, padded to 8
    slots: (JAX scene, port scene)."""
    import jax

    from helpers import scene_from_spheres
    from raytracingincuda_torch.models.convert import scene_from_numpy
    from raytracingincuda_tpu.models.scene import (DIELECTRIC, LAMBERTIAN,
                                                   METAL)

    js = scene_from_spheres([
        dict(center=(0, -1000, 0), radius=1000.0, mat=LAMBERTIAN,
             albedo=(0.5, 0.5, 0.5)),
        dict(center=(0, 1, 0), radius=1.0, mat=DIELECTRIC, ior=1.5),
        dict(center=(-2, 1, 0), radius=1.0, mat=LAMBERTIAN,
             albedo=(0.4, 0.2, 0.1)),
        dict(center=(2, 1, 0), radius=1.0, mat=METAL,
             albedo=(0.7, 0.6, 0.5), fuzz=0.1),
    ], pad_to=8)
    return js, scene_from_numpy([np.asarray(x) for x in
                                 jax.tree_util.tree_leaves(js)], device="cpu")


@pytest.fixture(scope="module")
def target():
    return np.random.default_rng(1).uniform(0, 1, (H, W, 3)).astype(np.float32)


def _close(got, want, frac, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


@pytest.mark.parametrize("rr", [None, 2])
def test_grad_reference_matches_pallas_grads(mixed, rr):
    """Kernel A's plain version vs the JAX full-park gradient kernel in
    interpret mode: 1e-3 of each output's largest entry."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.ops.pallas_backward import render_pallas_grads

    js, ts = mixed
    g = np.random.default_rng(2).standard_normal((H, W, 3)).astype(np.float32)
    want = render_pallas_grads(js, JCam.reference_default(), jnp.asarray(g), W,
                               H, SPP, DEPTH, interpret=True, park="hbm",
                               ray_tile=128, rr_start=rr)
    got = tk.render_kernel_grads(ts, TCam.reference_default(),
                                 torch.from_numpy(g), W, H, SPP, DEPTH,
                                 rr_start=rr)
    _close(got[0], want[0], 1e-3, "d_scene_mat")
    _close(got[1], want[1], 1e-3, "d_cam_row")
    assert not got[0][:, tk.GRAD_COLS:].any()
    assert not got[1][0, 18:].any()


def test_grad_reference_matches_eager_jax_oracle(mixed):
    """Kernel A's plain version chained to the parameters vs jax.vjp
    through the JAX oracle's raw radiance sum, op by op: 1e-3 of each
    leaf's largest entry (of all 12 for the camera's scalars)."""
    import jax
    import jax.numpy as jnp

    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.models.scene import Scene as JScene
    from raytracingincuda_tpu.ops import tracer as jtr

    js, ts = mixed
    g = np.random.default_rng(3).standard_normal((H, W, 3)).astype(np.float32)

    def render(p, c):
        return jtr.render(JScene(p, js.mat_type, js.active), c, W, H, SPP,
                          3, accumulate_only=True, rr_start=1)

    with jax.disable_jit():
        _, vjp = jax.vjp(render, js.params, JCam.reference_default())
        jp, jc = vjp(jnp.asarray(g))
    cam = TCam.reference_default()
    d_sm, d_cr = tk.render_kernel_grads(ts, cam, torch.from_numpy(g), W, H,
                                        SPP, 3, rr_start=1)
    tp, tc = tk.chain_to_params(d_sm, d_cr, ts.params, cam, ts.mat_type,
                                ts.active, W, H)
    for k, (a, b) in enumerate(zip(param_leaves(tp),
                                   jax.tree_util.tree_leaves(jp))):
        _close(a, b, 1e-3, f"param leaf {k}")
    jc = np.array([float(x) for x in jax.tree_util.tree_leaves(jc)])
    _close(torch.stack(config_leaves(tc)), jc, 1e-3, "camera")


@pytest.fixture(scope="module")
def pallas_fused(mixed, target):
    """mse_train_pallas (full park, interpret mode) for the four losses."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.ops.pallas_backward import mse_train_pallas

    js, _ = mixed
    return {loss: mse_train_pallas(js, JCam.reference_default(),
                                   jnp.asarray(target), W, H, SPP, DEPTH,
                                   interpret=True, park_residuals="hbm",
                                   ray_tile=128, rr_start=2, loss=loss,
                                   huber_delta=0.25)
            for loss in tk.LOSSES}


@pytest.mark.parametrize("loss", tk.LOSSES)
def test_fused_train_reference_matches_mse_train_pallas(mixed, target,
                                                        pallas_fused, loss):
    """Kernel B's plain version vs the JAX fused kernel (gamma on, rr2):
    loss to 1e-5; the image within 1e-5 (XLA's fused multiply-adds);
    cotangents to 1e-3 of each output's largest entry."""
    _, ts = mixed
    want = pallas_fused[loss]
    got = tk.fused_train(ts, TCam.reference_default(),
                         torch.from_numpy(target), W, H, SPP, DEPTH,
                         rr_start=2, loss=loss, huber_delta=0.25)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-5)
    _close(got[2], want[2], 1e-3, "d_scene_mat")
    _close(got[3], want[3], 1e-3, "d_cam_row")


def test_fused_image_is_the_render(mixed, target):
    """Kernel B's image is the regen render's, bit for bit, with gamma on
    and off."""
    _, ts = mixed
    cam = TCam.reference_default()
    for gamma in (True, False):
        _, img, _, _ = tk.fused_train(ts, cam, torch.from_numpy(target), W, H,
                                      SPP, DEPTH, rr_start=2, gamma=gamma)
        assert torch.equal(img, rk.render_kernel(ts, cam, W, H, SPP, DEPTH,
                                                 rr_start=2, gamma=gamma))


def test_chain_to_params_matches_jax(mixed):
    import jax
    import jax.numpy as jnp

    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.ops.pallas_backward import chain_to_params

    js, ts = mixed
    rng = np.random.default_rng(4)
    d_sm = rng.standard_normal((8, 16)).astype(np.float32)
    d_cr = rng.standard_normal((1, 24)).astype(np.float32)
    with jax.disable_jit():
        jp, jc = chain_to_params(jnp.asarray(d_sm), jnp.asarray(d_cr),
                                 js.params, JCam.reference_default(),
                                 js.mat_type, js.active, W, H)
    tp, tc = tk.chain_to_params(torch.from_numpy(d_sm), torch.from_numpy(d_cr),
                                ts.params, TCam.reference_default(),
                                ts.mat_type, ts.active, W, H)
    for a, b in zip(param_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the camera's chain runs through initialize()'s tan and rsqrt, where
    # eager JAX's rsqrt estimate differs: 1e-5 of the largest entry
    jc = np.array([float(x) for x in jax.tree_util.tree_leaves(jc)])
    _close(torch.stack(config_leaves(tc)), jc, 1e-5, "camera")


def test_sample_windows_add_up():
    """Cotangents are sums over samples: windows [0, 2) and [2, 4) add up
    to [0, 4) (to 1e-5 of the largest entry: summation order)."""
    s, cam = build_scene(2, device="cpu"), TCam.reference_default()
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (H, W, 3)).astype(np.float32))
    full = tk.render_kernel_grads(s, cam, g, W, H, 4, DEPTH, rr_start=1)
    a = tk.render_kernel_grads(s, cam, g, W, H, 2, DEPTH, rr_start=1)
    b = tk.render_kernel_grads(s, cam, g, W, H, 2, DEPTH, rr_start=1,
                               sample_offset=2)
    for x, y, z in zip(a, b, full):
        _close(x + y, z.numpy(), 1e-5, "windows")


def test_tile_chunks_and_pixel_order(target):
    """The fused step in three tile chunks and in a permuted lane order:
    the image bit-equal, loss and cotangents within 1e-5 (relative, of
    the largest entry): partial sums in another order."""
    s, cam = build_scene(2, device="cpu"), TCam.reference_default()
    w, h = 24, 16                       # three 128-lane tiles
    tgt = torch.from_numpy(np.random.default_rng(6).random(
        (h, w, 3)).astype(np.float32))
    base = tk.fused_train(s, cam, tgt, w, h, SPP, DEPTH, rr_start=2)
    tiled = tk.mse_train_tiled(s, cam, tgt, w, h, SPP, DEPTH, n_chunks=3,
                               rr_start=2)
    perm = torch.from_numpy(np.random.default_rng(7).permutation(384))
    ordered = tk.fused_train(s, cam, tgt, w, h, SPP, DEPTH, rr_start=2,
                             pixel_order=perm)
    for other in (tiled, ordered):
        assert torch.equal(other[1], base[1])
        np.testing.assert_allclose(float(other[0]), float(base[0]), rtol=1e-5)
        _close(other[2], base[2].numpy(), 1e-5, "d_scene_mat")
        _close(other[3], base[3].numpy(), 1e-5, "d_cam_row")
    part = tk.fused_train(s, cam, tgt, w, h, SPP, DEPTH, rr_start=2,
                          tile_chunk=(1, 1))
    assert part[1].shape == (3, rk.PAD)
    with pytest.raises(ValueError):
        tk.fused_train(s, cam, tgt, w, h, SPP, DEPTH, tile_chunk=(2, 2))


def test_depth_cap_and_arguments_raise():
    """The train kernels take every depth the sampler does: 65 runs, and
    257 raises with the sampler's own message, the one JAX's
    validate_stream_ids gives (JAX's make_diff_render raises with it;
    JAX's train kernels do not check, tests/test_torch_routes.py's
    DEPTH_DIVERGENCES)."""
    from raytracingincuda_tpu.ops.rng import validate_stream_ids

    s, cam = build_scene(2, device="cpu"), TCam.reference_default()
    ids, ii, jj, _, sm, row = rk.regen_inputs(s, cam, W, H, SPP)
    rows = torch.zeros((3, ids.shape[0]))
    assert tk.MAX_DEPTH == 256
    with pytest.raises(ValueError) as jax_err:
        validate_stream_ids(1, tk.MAX_DEPTH + 1)
    with pytest.raises(ValueError) as err:
        tk.grad_reference(ids, ii, jj, rows, sm, row, samples=1,
                          max_depth=tk.MAX_DEPTH + 1)
    assert str(err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="bounce counter field"):
        tk.fused_train(s, cam, torch.zeros((H, W, 3)), W, H, 1,
                       tk.MAX_DEPTH + 1)
    with pytest.raises(ValueError):
        tk.grad_reference(ids, ii, jj, rows[:2], sm, row, samples=1,
                          max_depth=2)
    with pytest.raises(ValueError, match="loss"):
        tk.fused_train(s, cam, torch.zeros((H, W, 3)), W, H, 1, 2,
                       loss="l2")
    # above the shallow stack's 64 bounces, and the north star's 50
    for depth in (tk.STACK_SHALLOW + 1, 50):
        tk.grad_reference(ids[:rk.PAD], ii[:rk.PAD], jj[:rk.PAD],
                          rows[:, :rk.PAD].contiguous(), sm, row, samples=1,
                          max_depth=depth)


def _window_bytes(plan, lanes, n):
    """One window's park and device-memory warp accumulators, in bytes."""
    acc = 0 if plan.acc_in_smem else lanes // 32 * n * tk.GRAD_COLS * 4
    return lanes * plan.capacity * 4 + acc


@pytest.mark.parametrize("lanes,samples,depth,n,layout,budget", [
    (1280 * 768, 100, 25, 512, "vmem", tk.PARK_BUDGET),  # the headline
    (1280 * 768, 100, 25, 512, "vmem", 1 << 28),
    (1280 * 768, 2, 25, 512, "vmem", tk.PARK_BUDGET),
    (64 * 40, 4, 6, 512, "vmem", 3 * (128 * 4 * 24 + 4 * 512 * 36)),
    (24 * 128, 4, 8, 3000, "hbm", 1 << 22),              # warp accumulators
    (7 * 128, 2, 3, 8, "vmem", 128 * 4 * 6 * 3),         # in device memory
    (1280 * 768, 100, 256, 512, "vmem", tk.PARK_BUDGET),  # the deepest
    (64 * 40, 4, 256, 512, "vmem", 5 * (128 * 4 * 4 * 256 + 4 * 512 * 36)),
])
def test_plan_park_windows_cover_lanes_within_budget(lanes, samples, depth, n,
                                                     layout, budget):
    """Every lane falls in exactly one window, windows are multiples of
    128 lanes, and a window's park (and device-memory accumulators) stay
    within the budget; the capacity never exceeds samples * depth."""
    plan = tk.plan_park(lanes, samples, depth, n, layout, budget=budget)
    covered = np.concatenate([np.arange(w0, w0 + c) for w0, c in plan.windows])
    np.testing.assert_array_equal(covered, np.arange(lanes))
    assert all(w0 % rk.PAD == 0 and c % rk.PAD == 0 and c > 0
               for w0, c in plan.windows)
    assert all(_window_bytes(plan, c, n) <= budget for _, c in plan.windows)
    assert 0 < plan.capacity <= samples * depth
    assert plan.acc_in_smem == (n < 100)


def test_plan_park_capacity_and_refusals():
    """The headline parks in one window, at least PARK_ENTRIES_PER_SAMPLE
    entries a sample (400; 315 is the 99.9th percentile of a lane's entries
    there, PERF.md); an explicit capacity is kept, with windows to fit it;
    kernel A's plan parks nothing; impossible plans raise."""
    head = tk.plan_park(1280 * 768, 100, 25, 512)
    assert head.windows == [(0, 1280 * 768)] and head.capacity >= 400
    plan = tk.plan_park(64 * 40, 4, 6, 512, capacity=3, budget=8 * 128 * 12,
                        acc="shared")
    assert plan.capacity == 3 and len(plan.windows) == 3
    assert tk.plan_park(64 * 40, 4, 6, 512, capacity=0).windows == [(0, 2560)]
    assert not tk.plan_park(64 * 40, 4, 6, 512).acc_in_smem
    assert tk.plan_park(64 * 40, 4, 6, 512, acc="shared").acc_in_smem
    assert tk.plan_park(64 * 40, 4, 6, 64).acc_in_smem
    with pytest.raises(ValueError):
        tk.plan_park(100, 4, 6, 512)
    with pytest.raises(ValueError):
        tk.plan_park(2560, 4, 6, 3000, "hbm", acc="shared")
    with pytest.raises(ValueError):
        tk.plan_park(2560, 4, 6, 512, capacity=10, budget=128 * 4 * 9)


def test_plan_park_follows_tile_chunks():
    """make_tiled_train's chunks keep their lanes: each chunk's plan covers
    exactly its count * 128 lanes, from the chunk's first lane."""
    w, h = 24, 16
    tiles = w * h // rk.PAD
    for t0, count in [(0, 1), (1, 1), (1, 2), (0, tiles)]:
        plan = tk.plan_park(count * rk.PAD, SPP, DEPTH, 8,
                            budget=count * rk.PAD * 4 * SPP * DEPTH // 2)
        assert sum(c for _, c in plan.windows) == count * rk.PAD
        assert plan.windows[0][0] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("rr", [None, 2])
@pytest.mark.parametrize("layout", ["vmem", "hbm"])
def test_grad_kernel_equals_plain_version_on_card(cuda, rr, layout):
    """Kernel A vs its plain version on the card: 1e-4 of the largest
    entry (summation order), and the same bits from run to run."""
    s = build_scene(1, device=cuda)
    ids, ii, jj, _, sm, row = rk.regen_inputs(s, TCam.reference_default(),
                                              64, 40, 2)
    g = torch.randn((3, ids.shape[0]), generator=torch.Generator().manual_seed(
        0)).to(cuda)
    kw = dict(samples=2, max_depth=8, rr_start=rr, layout=layout)
    before = trace.counts().get("launch.grad_render", 0)
    got = tk.grad_kernel(ids, ii, jj, g, sm, row, **kw)
    again = tk.grad_kernel(ids, ii, jj, g, sm, row, **kw)
    torch.cuda.synchronize()
    assert trace.counts().get("launch.grad_render", 0) == before + 2
    want = tk.grad_reference(ids, ii, jj, g, sm, row, **kw)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        _close(a, c.cpu().numpy(), 1e-4, "kernel A")


@pytest.mark.cuda
@pytest.mark.parametrize("loss", tk.LOSSES)
def test_fused_kernel_equals_plain_version_on_card(cuda, loss):
    """Kernel B vs its plain version on the card: the image bit-equal (and
    to the regen kernel's), loss to 1e-6, cotangents to 1e-4 of the
    largest entry; two launches (the park render and the reverse) in one
    window."""
    s = build_scene(1, device=cuda)
    ids, ii, jj, bud, sm, row = rk.regen_inputs(s, TCam.reference_default(),
                                                64, 40, 4)
    tgt = torch.rand((3, ids.shape[0]), generator=torch.Generator().manual_seed(
        1)).to(cuda)
    kw = dict(samples=4, max_depth=6, rr_start=2, num_pixels=64 * 40,
              loss=loss, huber_delta=0.25)
    before = trace.counts().get("launch.fused_train_render", 0)
    got = tk.fused_train_kernel(ids, ii, jj, tgt, sm, row, **kw)
    torch.cuda.synchronize()
    assert trace.counts().get("launch.fused_train_render", 0) == before + 2
    want = tk.fused_train_reference(ids, ii, jj, tgt, sm, row, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[1], rk.regen_kernel(ids, ii, jj, bud, sm, row,
                                               samples=4, max_depth=6,
                                               rr_start=2,
                                               finalize_scale=0.25))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    _close(got[2], want[2].cpu().numpy(), 1e-4, "d_scene_mat")
    _close(got[3], want[3].cpu().numpy(), 1e-4, "d_cam_row")


def _card_inputs(cuda, spp):
    s = build_scene(1, device=cuda)
    ids, ii, jj, _, sm, row = rk.regen_inputs(s, TCam.reference_default(),
                                              64, 40, spp)
    tgt = torch.rand((3, ids.shape[0]), generator=torch.Generator().manual_seed(
        2)).to(cuda)
    return ids, ii, jj, tgt, sm, row


@pytest.mark.cuda
@pytest.mark.parametrize("rr", [None, 2])
def test_fused_gradients_bit_equal_across_capacities_and_windows_on_card(
        cuda, rr):
    """Kernel B's outputs are the same bits with nothing parked, with a
    capacity that overflows mid-lane, with the default, in two window
    sizes and with the warps' accumulators in shared memory: a sample's
    cotangents enter the sums in the same order whether it was parked or
    re-traced."""
    args = _card_inputs(cuda, 4)
    kw = dict(samples=4, max_depth=6, rr_start=rr, num_pixels=64 * 40)
    want = tk.fused_train_kernel(*args, **kw)
    small = tk.fused_train_parts(*args, capacity=5, **kw)
    parked = small.parked[0].cpu()
    assert bool((parked > 0).any()) and bool((parked < 4).any())
    one_block = 128 * 4 * 4 * 6 + 4 * 512 * 36  # park and accumulators
    for extra in (dict(capacity=0), dict(capacity=5),
                  dict(budget=2 * one_block), dict(budget=7 * one_block),
                  dict(acc="shared")):
        plan = tk.fused_train_parts(*args, **extra, **kw).plan
        if "budget" in extra:
            assert len(plan.windows) > 1
        got = tk.fused_train_kernel(*args, **extra, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), extra


@pytest.mark.cuda
@pytest.mark.parametrize("rr", [None, 2])
def test_fused_gradients_equal_grad_kernel_on_its_g_on_card(cuda, rr):
    """Kernel A fed kernel B's own g gives kernel B's gradients bit for
    bit: one reverse."""
    args = _card_inputs(cuda, 4)
    kw = dict(samples=4, max_depth=6, rr_start=rr)
    parts = tk.fused_train_parts(*args, num_pixels=64 * 40, **kw)
    fused = tk.fused_train_kernel(*args, num_pixels=64 * 40, **kw)
    ids, ii, jj, _, sm, row = args
    got = tk.grad_kernel(ids, ii, jj, parts.g, sm, row, **kw)
    assert torch.equal(got[0], fused[2]) and torch.equal(got[1], fused[3])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cover", "tie", "random2000"])
def test_two_level_scan_in_kernels_2_and_3_on_card(cuda, name, monkeypatch):
    """Kernel 2's park render scans in two levels (layout 'vmem'), the
    reverse (kernel 2's and kernel 3) in one: the image is the plain
    version's bit for bit, and the park's counts, the image, g, the loss
    and the gradients are the same bits as the launches scanning in one
    level, with the default park and with nothing parked (every sample
    re-traced in the reverse); kernel 3's gradients likewise; the
    gradients are the plain version's within 1e-4 of the largest entry."""
    from group_scenes import one_level, scene_named

    ids, ii, jj, bud, sm, row = rk.regen_inputs(
        scene_named(name, cuda), TCam.reference_default(), 64, 40, 2)
    tgt = torch.rand((3, ids.shape[0]), generator=torch.Generator().manual_seed(
        2)).to(cuda)
    kw = dict(samples=2, max_depth=8, rr_start=2, num_pixels=64 * 40)
    before = (trace.counts().get("scan.two_level", 0),
              trace.counts().get("scan.one_level", 0))
    parts = [tk.fused_train_parts(ids, ii, jj, tgt, sm, row, capacity=c, **kw)
             for c in (None, 0)]
    fused = tk.fused_train_kernel(ids, ii, jj, tgt, sm, row, **kw)
    grad = tk.grad_kernel(ids, ii, jj, tgt, sm, row, samples=2, max_depth=8,
                          rr_start=2)
    torch.cuda.synchronize()
    assert (trace.counts().get("scan.two_level", 0),
            trace.counts().get("scan.one_level", 0)) == (before[0] + 3,
                                                         before[1] + 4)
    want = tk.fused_train_reference(ids, ii, jj, tgt, sm, row, **kw)
    assert torch.equal(fused[1], want[1])
    _close(fused[2], want[2].cpu().numpy(), 1e-4, "d_scene_mat")
    _close(fused[3], want[3].cpu().numpy(), 1e-4, "d_cam_row")
    one_level(monkeypatch)
    for c, got in zip((None, 0), parts):
        one = tk.fused_train_parts(ids, ii, jj, tgt, sm, row, capacity=c, **kw)
        for a, b in zip(got[:6], one[:6]):
            assert torch.equal(a, b), c
    for a, b in zip(fused, tk.fused_train_kernel(ids, ii, jj, tgt, sm, row,
                                                 **kw)):
        assert torch.equal(a, b)
    for a, b in zip(grad, tk.grad_kernel(ids, ii, jj, tgt, sm, row, samples=2,
                                         max_depth=8, rr_start=2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_grad_kernel_device_accumulators_on_card(cuda):
    """Above about 1,500 slots (layout hbm) the warps' accumulators live in
    device memory: kernel A against its plain version, 1e-4 of the largest
    entry, and the same bits from run to run and with a small budget (more
    windows)."""
    from raytracingincuda_torch.models.scene import build_random_scene

    s = build_random_scene(2000, seed=3, device=cuda)
    ids, ii, jj, _, sm, row = rk.regen_inputs(s, TCam.reference_default(),
                                              32, 24, 2)
    g = torch.randn((3, ids.shape[0]), generator=torch.Generator().manual_seed(
        3)).to(cuda)
    kw = dict(samples=2, max_depth=5, rr_start=2, layout="hbm")
    assert not tk.plan_park(ids.shape[0], 2, 5, 2000, "hbm").acc_in_smem
    got = tk.grad_kernel(ids, ii, jj, g, sm, row, **kw)
    windows = tk.grad_kernel(ids, ii, jj, g, sm, row, budget=4 * 2000 * 36 * 2,
                             **kw)
    want = tk.grad_reference(ids, ii, jj, g, sm, row, **kw)
    for a, b, c in zip(got, windows, want):
        assert torch.equal(a, b)
        _close(a, c.cpu().numpy(), 1e-4, "kernel A, device accumulators")


@pytest.mark.cuda
@pytest.mark.parametrize("rr", [None, 2])
def test_deep_instance_on_card(cuda, rr):
    """The reverse's 256-deep instance: at depth 64 it gives the 64-deep
    instance's gradients bit for bit (kernels A and B); at depth 128 on
    the deep scene of test_torch_deep.py, kernel A and B against their
    plain versions (the image bit-equal, gradients within 1e-4 of the
    largest entry), the same bits from run to run."""
    from raytracingincuda_torch.models.scene import build_deep_scene

    args = _card_inputs(cuda, 2)
    kw = dict(samples=2, max_depth=tk.STACK_SHALLOW, rr_start=rr)
    ids, ii, jj, tgt, sm, row = args
    for stack in (tk.STACK_SHALLOW, tk.MAX_DEPTH):
        a = tk.grad_kernel(ids, ii, jj, tgt, sm, row, stack=stack, **kw)
        b = tk.fused_train_kernel(*args, num_pixels=64 * 40, stack=stack,
                                  **kw)
        if stack == tk.STACK_SHALLOW:
            want_a, want_b = a, b
        else:
            assert all(torch.equal(x, y) for x, y in zip(a, want_a))
            assert all(torch.equal(x, y) for x, y in zip(b, want_b))
    s = build_deep_scene(device=cuda)
    ids, ii, jj, _, sm, row = rk.regen_inputs(s, TCam.reference_default(),
                                              64, 40, 2)
    tgt = torch.rand((3, ids.shape[0]), generator=torch.Generator().manual_seed(
        5)).to(cuda)
    kw = dict(samples=2, max_depth=128, rr_start=rr)
    got = tk.grad_kernel(ids, ii, jj, tgt, sm, row, **kw)
    again = tk.grad_kernel(ids, ii, jj, tgt, sm, row, **kw)
    want = tk.grad_reference(ids, ii, jj, tgt, sm, row, **kw)
    for x, y, z in zip(got, again, want):
        assert torch.equal(x, y)
        _close(x, z.cpu().numpy(), 1e-4, "kernel A, deep")
    f_kw = dict(kw, num_pixels=64 * 40)
    got = tk.fused_train_kernel(ids, ii, jj, tgt, sm, row, **f_kw)
    want = tk.fused_train_reference(ids, ii, jj, tgt, sm, row, **f_kw)
    assert torch.equal(got[1], want[1])
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    _close(got[2], want[2].cpu().numpy(), 1e-4, "kernel B, deep")
    _close(got[3], want[3].cpu().numpy(), 1e-4, "kernel B camera, deep")
