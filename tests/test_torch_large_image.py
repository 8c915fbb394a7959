"""Images of 2^24 pixels and more, up to ``kernel_io.MAX_LANES`` lanes.

The JAX package renders such images wherever a lane holds one pixel; the
port, whose lanes always hold one, takes them on every kernel route. The
pixel id keys the Threefry stream, so ids of 2^24 and more are where the
two packages could first part. Nothing here renders a whole large image
on the CPU: the lane plumbing and the window plans run at full size, and
the renders and gradients run on 256 lanes whose pixel ids are >= 2^24
(the last pixel of 7680x4320 among them), against JAX's
``tracer.trace_sample`` run op by op (``jax.disable_jit()``) on the same
uint32 ids, summed over 4 samples at 8 bounces.

Tolerances. Radiance sums: each (lane, channel) within 1e-5, except where
a knife-edge bounce under XLA's approximate rsqrt sends a path elsewhere
(ROADMAP queue 3): at most 1% of them (measured: none on scene 1, 3 of
768 on the stream scene at parity); the lanes' gamma'd means pass the
cross-framework gate of ``utils/ppm.py``, as the stream tests' images do.
Gradients: 1e-3 of each output's largest entry, as
``test_torch_train_kernel.py`` holds the plain gradients to the eager JAX
oracle (measured here: 1.5e-5). The ``cuda`` tests hold kernels 1, 3 and
4 over every lane of a 4096x4104 image to their plain versions on sampled
lanes (images bit for bit; gradients at the card tests' 1e-4 of the
largest entry) and skip without a card; JAX is imported inside the tests
that use it, so that ``pytest --noconftest -m cuda`` runs this file on a
machine without JAX.
"""
import io

import numpy as np
import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.camera import initialize
from raytracingincuda_torch.models.scene import (build_random_scene,
                                                 build_scene)
from raytracingincuda_torch.ops import kernel_io as kio
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import stream_kernel as sk
from raytracingincuda_torch.ops import stream_train_kernel as stk
from raytracingincuda_torch.ops import train_kernel as tk
from raytracingincuda_torch.ops.tracer import linear_to_gamma
from raytracingincuda_torch.utils import ppm

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

SIZES = {"4096x4104": (4096, 4104), "8K UHD": (7680, 4320)}
W, H = SIZES["8K UHD"]
SPP, DEPTH, LANES = 4, 8, 256
SUM_ATOL, FLIPPED_SHARE = 1e-5, 0.01
GRAD_FRAC, CARD_GRAD_FRAC = 1e-3, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def _ids() -> np.ndarray:
    """256 pixel ids of 7680x4320, all >= 2^24: its first two ids there,
    its last pixel and 253 drawn between."""
    n = W * H
    rng = np.random.default_rng(0)
    return np.concatenate([[1 << 24, (1 << 24) + 1, n - 1],
                           rng.integers(1 << 24, n - 1, LANES - 3)])


def _lanes(ids: np.ndarray, width: int, device="cpu"):
    """(ids int32, ii, jj) lane rows for these pixel ids of an image
    ``width`` wide, as ``_lane_setup`` builds them."""
    t = torch.from_numpy(ids.astype(np.int32)).to(device)
    return (t, (t.long() % width).float(),
            torch.div(t.long(), width, rounding_mode="floor").float())


def _jax_and_port_scene(kind):
    import jax

    from raytracingincuda_torch.models.convert import scene_from_numpy
    from raytracingincuda_tpu.models.scene import build_random_scene as jbrs
    from raytracingincuda_tpu.models.scene import build_scene as jbs

    js = jbs(1) if kind == "scene 1" else jbrs(300, pad_to_multiple=128,
                                               half_extent=10.0)
    return js, scene_from_numpy([np.asarray(x) for x in
                                 jax.tree_util.tree_leaves(js)], device="cpu")


def _jax_trace(js, ids, rr, g=None):
    """JAX's trace_sample on the uint32 ids, op by op, summed over SPP
    samples: the (3, lanes) sums, and with a cotangent ``g`` (3, lanes)
    jax.vjp's (scene params, derived camera) cotangents too."""
    import jax
    import jax.numpy as jnp

    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.models.camera import initialize as jinit
    from raytracingincuda_tpu.models.scene import Scene as JScene
    from raytracingincuda_tpu.ops import rng as jrng
    from raytracingincuda_tpu.ops import tracer as jtr

    pid = jnp.asarray(ids.astype(np.uint32))
    key = jrng.key_from_seed(jrng.DEFAULT_SEED)

    def sums(params, cam):
        scene = JScene(params, js.mat_type, js.active)
        return sum(jnp.stack(list(jtr.trace_sample(
            scene, cam, pid, W, jnp.uint32(s), key, DEPTH, rr_start=rr)))
            for s in range(SPP))

    cam = jinit(JCam.reference_default(), W, H)
    with jax.disable_jit():
        if g is None:
            return np.asarray(sums(js.params, cam)), None
        out, vjp = jax.vjp(sums, js.params, cam)
        jp, jc = vjp(jnp.asarray(g))
    # the port's packed layouts: scene-matrix columns 0-8, camera row 0-17
    d_sm = np.stack([np.asarray(x) for x in (*jp.center, jp.radius,
                                             *jp.albedo, jp.fuzz, jp.ior)], 1)
    d_cam = np.concatenate([np.asarray(list(v), np.float32) for v in (
        jc.pixel00_loc, jc.pixel_delta_u, jc.pixel_delta_v, jc.center,
        jc.defocus_disk_u, jc.defocus_disk_v)])
    return np.asarray(out), (d_sm, d_cam)


def _cotangent() -> np.ndarray:
    return np.random.default_rng(1).standard_normal((3, LANES)).astype(
        np.float32)


@pytest.fixture(scope="module", params=[None, 2], ids=["parity", "rr2"])
def scene1_jax(request):
    """Scene 1 at 7680x4320 on ``_ids()``: JAX's sums and cotangents (one
    jax.vjp a estimator serves the render and the gradient tests)."""
    rr = request.param
    js, ts = _jax_and_port_scene("scene 1")
    sums, grads = _jax_trace(js, _ids(), rr, _cotangent())
    return rr, ts, sums, grads


def _port_inputs(ts):
    return (rk.pack_scene_matrix(ts),
            rk.pack_camera(initialize(TCam.reference_default(), W, H)))


def _assert_sums_close(got, want):
    got = got.numpy()
    off = np.abs(got - want) > SUM_ATOL
    assert off.mean() <= FLIPPED_SHARE, (off.sum(), np.abs(got - want).max())

    def image(sums):     # the lanes as a (1, lanes, 3) gamma'd image
        return linear_to_gamma(torch.from_numpy(sums.T / SPP)).numpy()[None]

    st = ppm.diff_stats(image(got), ppm.quantize(image(want)))
    assert ppm.passes_cross_framework_gate(st), st


# -- lanes --------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
def test_lane_setup_exact_at_large_sizes(size):
    """Every lane of the image, its coordinates exact: ii == id % W and
    jj == id // W as integers, the budget row the sample count."""
    w, h = SIZES[size]
    ids, ii, jj, budget = kio.lane_setup(w, h, None, 4, 0, None, "cpu")
    assert ids.shape == (w * h,) and w * h % rk.PAD == 0
    assert ids.dtype == torch.int32 and int(ids[-1]) == w * h - 1
    assert torch.equal(ids, torch.arange(w * h, dtype=torch.int32))
    pid = ids.long()
    assert torch.equal(ii.long(), pid % w)
    assert torch.equal(jj.long(), torch.div(pid, w, rounding_mode="floor"))
    assert float(ii[-1]) == w - 1 and float(jj[-1]) == h - 1
    assert bool((budget == 4.0).all())


def test_lanes_above_the_cap_raise():
    """MAX_LANES is the largest multiple of 128 lanes whose (3, lanes)
    index products fit int32. An image that pads above it, a mesh whose
    ranks' padding takes it above, and lane rows longer than it raise
    with the cap's name, before any lane exists."""
    from raytracingincuda_torch.parallel.mesh import Mesh

    cap = kio.MAX_LANES
    assert cap % rk.PAD == 0 and 3 * cap <= 2**31 - 1
    assert 3 * (cap + rk.PAD) > 2**31 - 1
    with pytest.raises(ValueError, match="MAX_LANES"):
        kio.lane_setup(32768, 32768, None, 1, 0, None, "cpu")
    with pytest.raises(ValueError, match="MAX_LANES"):
        kio.lane_setup(cap + 1, 1, None, 1, 0, None, "cpu")
    two = Mesh(None, 0, 2, torch.device("cpu"), ("dp",), (2,))
    with pytest.raises(ValueError, match="MAX_LANES"):
        kio.lane_setup(cap - 1, 1, None, 1, 0, None, "cpu", two)
    meta = dict(device="meta")
    n = cap + rk.PAD
    ids = torch.empty(n, dtype=torch.int32, **meta)
    f = torch.empty(n, **meta)
    with pytest.raises(ValueError, match="MAX_LANES"):
        rk.regen_reference(ids, f, f, f, torch.empty((8, rk.NUM_COLS),
                                                     **meta),
                           torch.empty((1, 24), **meta), samples=1,
                           max_depth=1)


# -- renders and gradients against JAX --------------------------------------

def test_regen_reference_past_2_24_matches_jax(scene1_jax):
    """Kernel 1's plain version on 256 lanes of 7680x4320 with ids >= 2^24
    against JAX's trace_sample on the same ids."""
    rr, ts, want, _ = scene1_jax
    ids, ii, jj = _lanes(_ids(), W)
    got = rk.regen_reference(ids, ii, jj, torch.full((LANES,), float(SPP)),
                             *_port_inputs(ts), samples=SPP, max_depth=DEPTH,
                             rr_start=rr)
    _assert_sums_close(got, want)


@pytest.mark.parametrize("rr", [None, 2], ids=["parity", "rr2"])
def test_stream_reference_past_2_24_matches_jax(rr):
    """Kernel 4's plain version (300 random spheres in blocks of 64) on the
    same lanes against JAX's trace_sample on the unstreamed scene."""
    js, ts = _jax_and_port_scene("stream")
    want, _ = _jax_trace(js, _ids(), rr)
    st = sk.prepare_stream_scene(ts, block=64)
    ids, ii, jj = _lanes(_ids(), W)
    got = sk.stream_reference(ids, ii, jj, torch.full((LANES,), float(SPP)),
                              st.scene_mat, st.bounds, _port_inputs(ts)[1],
                              block=64, samples=SPP, max_depth=DEPTH,
                              rr_start=rr)
    _assert_sums_close(got, want)


def test_grad_reference_past_2_24_matches_jax_vjp(scene1_jax):
    """Kernel 3's plain version on the same lanes and cotangent rows
    against jax.vjp of the same JAX trace: the scene matrix's nine
    gradient columns and the camera row's 18 entries."""
    rr, ts, _, (want_sm, want_cam) = scene1_jax
    ids, ii, jj = _lanes(_ids(), W)
    d_sm, d_cam = tk.grad_reference(ids, ii, jj,
                                    torch.from_numpy(_cotangent()),
                                    *_port_inputs(ts), samples=SPP,
                                    max_depth=DEPTH, rr_start=rr)
    for got, want in ((d_sm[:, :kio.GRAD_COLS], want_sm), (d_cam[0, :18],
                                                          want_cam)):
        got = got.numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_FRAC * np.abs(want).max())


# -- windows and loss constants at these sizes ------------------------------

def _contiguous(spans, lanes):
    """(first lane, lanes) spans tile [0, lanes) in order, in whole
    blocks of PAD lanes."""
    end = 0
    for l0, n in spans:
        assert l0 == end and n > 0 and l0 % rk.PAD == 0 and n % rk.PAD == 0
        end = l0 + n
    assert end == lanes


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("samples,depth,n,layout", [
    (2, 25, 512, "vmem"),         # the slice's train step (scene 1), rr2
    (4, 25, 512, "hbm"),
    (1, 8, 3000, "hbm"),          # device-memory warp accumulators
    (16, 50, 8, "vmem"),          # accumulators in shared memory
])
def test_plan_park_windows_at_large_sizes(size, samples, depth, n, layout):
    """Kernel 2's windows tile every lane of the image in blocks of 128,
    each window's park and device-memory accumulators within PARK_BUDGET,
    the capacity at least PARK_ENTRIES_PER_SAMPLE a sample; kernel 3's
    plan (nothing parked) likewise."""
    lanes = int(np.prod(SIZES[size]))
    for capacity in (None, 0):
        plan = tk.plan_park(lanes, samples, depth, n, layout,
                            capacity=capacity)
        _contiguous(plan.windows, lanes)
        acc = 0 if plan.acc_in_smem else tk._WARPS * n * kio.GRAD_COLS * 4
        for _, count in plan.windows:
            assert (count * plan.capacity * 4 + count // rk.PAD * acc
                    <= tk.PARK_BUDGET)
        if capacity is None:
            assert (min(samples * depth, tk.PARK_ENTRIES_PER_SAMPLE * samples)
                    <= plan.capacity <= samples * depth)
        else:
            assert plan.capacity == 0


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("samples,depth", [(1, 10), (4, 25), (1, 256)])
def test_plan_records_windows_at_large_sizes(size, samples, depth):
    """Kernel 5's windows: one sample of every lane does not fit 2 GiB of
    records at these sizes (4096x4104x1spp/10b is 168 M records), so each
    sample splits into lane chunks that tile the image in order, each
    within RECORD_BUDGET; the samples come in order."""
    lanes = int(np.prod(SIZES[size]))
    assert lanes * depth * stk.RECORD_BYTES > stk.RECORD_BUDGET
    plan = stk.plan_records(lanes, samples, depth)
    assert [w.sample0 for w in plan] == sorted(w.sample0 for w in plan)
    for s in range(samples):
        mine = [w for w in plan if w.sample0 == s]
        assert all(w.samples == 1 for w in mine)
        _contiguous([(w.lane0, w.lanes) for w in mine], lanes)
    assert all(w.lanes * depth * stk.RECORD_BYTES <= stk.RECORD_BUDGET
               for w in plan)


@pytest.mark.parametrize("size", SIZES)
def test_loss_constants_at_large_sizes(size):
    """The loss block's 1/(3 num_pixels) weight at 17-33 M pixels, rounded
    to f32 as JAX's kernel rounds its Python constant."""
    import jax.numpy as jnp

    n = int(np.prod(SIZES[size]))
    k = tk.loss_constants(2, n, 1.0)
    w = 1.0 / (n * 3)
    assert k["w"] == float(jnp.float32(w)) == float(np.float32(w))
    assert k["two_w"] == float(jnp.float32(2.0 * w))
    assert k["w"] > 0.0 and k["inv_spp"] == 0.5


def test_adaptive_bucket_order_at_large_size():
    """The refine's pixel order at 4096x4104 (base 4, max 16): the budgets
    quantised to 32 buckets in int32 and sorted stably, equal to numpy's
    stable sort of the same buckets, and a permutation of every lane."""
    from raytracingincuda_torch.ops import adaptive

    w, h = SIZES["4096x4104"]
    extra = torch.from_numpy(np.random.default_rng(5).integers(
        0, 13, (h, w)).astype(np.int32))
    order = adaptive.bucket_order(extra, 12, w * h)
    buckets = extra.reshape(-1).numpy().astype(np.int64) * adaptive.N_BUCKETS
    want = np.argsort(np.clip(buckets // 12, 0, adaptive.N_BUCKETS - 1),
                      kind="stable")
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), want)


# -- the CLI's PPM writer -----------------------------------------------------

def _formatted_ppm(path, img):
    """The writer as it was: one formatted line a pixel."""
    q = ppm.quantize(img)
    h, w, _ = q.shape
    buf = io.StringIO()
    buf.write(f"P3\n{w} {h}\n255\n")
    buf.write("\n".join(f"{r} {g} {b}" for r, g, b in q.reshape(-1, 3)))
    buf.write("\n")
    with open(path, "w") as f:
        f.write(buf.getvalue())


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (24, 40), (97, 131)])
def test_write_ppm_bytes_equal_the_formatted_writer(tmp_path, shape):
    """The table-driven writer's bytes equal one formatted line a pixel,
    with values below 0, at 0, at and above 0.999 (clamped) among them."""
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(-0.5, 1.5, (*shape, 3)).astype(np.float32)
    img.reshape(-1)[:4] = [0.0, 0.999, 0.9989, 1.0][:img.size]
    _formatted_ppm(tmp_path / "a.ppm", img)
    ppm.write_ppm(str(tmp_path / "b.ppm"), img)
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()


def test_write_ppm_chunks(tmp_path, monkeypatch):
    """Chunks of 7 pixels give the same bytes as one chunk."""
    img = np.random.default_rng(7).uniform(0, 1, (9, 11, 3))
    ppm.write_ppm(str(tmp_path / "one.ppm"), img)
    monkeypatch.setattr(ppm, "_WRITE_CHUNK", 7)
    ppm.write_ppm(str(tmp_path / "many.ppm"), img)
    assert ((tmp_path / "one.ppm").read_bytes()
            == (tmp_path / "many.ppm").read_bytes())
    got, maxval = ppm.read_ppm(str(tmp_path / "many.ppm"))
    assert maxval == 255 and np.array_equal(got, ppm.quantize(img))


# -- the kernels on sampled lanes of a 4096x4104 image (card only) ----------

def _sampled(padded: int, device) -> torch.Tensor:
    """4096 lane indices: the image's last 2048 lanes and 2048 drawn from
    the lanes >= 2^24, sorted."""
    rng = np.random.default_rng(3)
    pick = np.concatenate([np.arange(padded - 2048, padded),
                           rng.choice(np.arange(1 << 24, padded - 2048),
                                      2048, replace=False)])
    return torch.from_numpy(np.sort(pick)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("rr", [None, 2])
def test_regen_kernel_on_large_image_on_card(cuda, rr):
    """Kernel 1 over every lane of 4096x4104 (2 spp, 8 bounces, scene 1)
    against its plain version on sampled lanes >= 2^24, bit for bit."""
    w, h = SIZES["4096x4104"]
    inputs = rk.regen_inputs(build_scene(1, device=cuda),
                             TCam.reference_default(), w, h, 2)
    kw = dict(samples=2, max_depth=8, rr_start=rr, finalize_scale=0.5)
    got = rk.regen_kernel(*inputs, **kw)
    sel = _sampled(w * h, cuda)
    sub = tuple(t[sel].contiguous() for t in inputs[:4])
    want = rk.regen_reference(*sub, *inputs[4:], **kw)
    assert torch.equal(got[:, sel], want)


@pytest.mark.cuda
def test_grad_kernel_on_large_image_on_card(cuda):
    """Kernel 3 over every lane of 4096x4104 (2 spp, 8 bounces, rr2) with
    g zero except on sampled lanes >= 2^24, against its plain version on
    those lanes: 1e-4 of the largest entry."""
    w, h = SIZES["4096x4104"]
    ids, ii, jj, _, sm, row = rk.regen_inputs(
        build_scene(1, device=cuda), TCam.reference_default(), w, h, 2)
    sel = _sampled(w * h, cuda)
    g_sel = torch.randn((3, sel.shape[0]), generator=torch.Generator()
                        .manual_seed(4)).to(cuda)
    g = torch.zeros((3, w * h), device=cuda)
    g[:, sel] = g_sel
    kw = dict(samples=2, max_depth=8, rr_start=2)
    got = tk.grad_kernel(ids, ii, jj, g, sm, row, **kw)
    want = tk.grad_reference(ids[sel].contiguous(), ii[sel].contiguous(),
                             jj[sel].contiguous(), g_sel, sm, row, **kw)
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=CARD_GRAD_FRAC
                                   * max(np.abs(b).max(), 1e-30))


@pytest.mark.cuda
def test_stream_kernel_on_large_image_on_card(cuda):
    """Kernel 4 over every lane of 4096x4104 (1000 random spheres in
    blocks of 64, 1 spp, 6 bounces) against its plain version on sampled
    lanes >= 2^24, bit for bit."""
    w, h = SIZES["4096x4104"]
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(build_random_scene(1000, seed=3,
                                                    device=cuda), block=64)
    ids, ii, jj, bud = kio.lane_setup(w, h, None, 1, 0, None, cuda)
    row = rk.pack_camera(initialize(cam, w, h)).to(cuda)
    kw = dict(block=64, samples=1, max_depth=6, finalize_scale=1.0)
    got = sk.stream_kernel(ids, ii, jj, bud, st.scene_mat, st.bounds, row,
                           **kw)
    sel = _sampled(w * h, cuda)
    sub = tuple(t[sel].contiguous() for t in (ids, ii, jj, bud))
    want = sk.stream_reference(*sub, st.scene_mat, st.bounds, row, **kw)
    assert torch.equal(got[:, sel], want)
