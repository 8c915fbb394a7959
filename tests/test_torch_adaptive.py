"""Adaptive sampling (ops/adaptive.py) against the JAX package.

The helpers are held to JAX run eagerly, op by op, on seeded numpy
inputs: XLA's jit fuses the luminance's three-term dot into multiply-adds
(ROADMAP queue 3), so JAX's jitted plan is not the reference here; the
eager one is the same f32 operations in the same order. The render is
held to a composition of the JAX Pallas kernel in interpret mode (the
probes, then the refines at the port's own budgets) under the
cross-framework gate of ``utils/ppm.py``, and to the JAX tests'
invariants. On the CPU the phases run the kernels' plain versions; the
``cuda`` test holds the card to them bit for bit and skips without a
card. JAX is imported inside the tests that use it, so that the card's
machine, which has no JAX, can run that test (``pytest --noconftest -m
cuda``).
"""
import numpy as np
import pytest
import torch

from raytracingincuda_torch.config import RenderConfig
from raytracingincuda_torch.models.camera import CameraConfig, initialize
from raytracingincuda_torch.models.scene import build_random_scene, build_scene
from raytracingincuda_torch.ops import adaptive as ad
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import stream_kernel as sk
from raytracingincuda_torch.ops.tracer import linear_to_gamma
from raytracingincuda_torch.render_api import make_renderer
from raytracingincuda_torch.utils import ppm

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

W, H, D = 40, 24, 6
BASE, MAX, TOL = 4, 16, 0.1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def _ulps(a, b) -> int:
    """Largest distance in f32 units in the last place."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


def _sums(rng, shape=(12, 20)):
    """Raw radiance sums of two half-buffers, with dark, bright and
    equal pixels."""
    a = rng.gamma(1.0, 2.0, shape + (3,)).astype(np.float32)
    noise = rng.normal(0.0, 0.1, shape + (3,)) * rng.random(shape + (1,))
    b = (a * (1.0 + noise)).astype(np.float32)
    a[0, :3] = b[0, :3]                     # identical buffers: error 0
    a[1, :4] *= 1e-3                        # dark: the 0.05 floor
    b[1, :4] *= 1e-3
    return a, b


@pytest.mark.parametrize("per_pixel_half", [False, True])
def test_helpers_match_eager_jax(per_pixel_half):
    """split_buffer_error, _dilate_blur and budgets_from_error against
    JAX's, op by op: error maps within 1 ulp (bit-equal in practice),
    budgets equal, at a scalar and a per-pixel half and count."""
    import jax
    import jax.numpy as jnp

    from raytracingincuda_tpu.ops import adaptive as jad

    rng = np.random.default_rng(11)
    a, b = _sums(rng)
    counts = (rng.integers(2, 9, a.shape[:2]) * 2).astype(np.int32)
    half = np.maximum(counts // 2, 1) if per_pixel_half else 4
    base = counts if per_pixel_half else 8
    with jax.disable_jit():
        want_err = np.asarray(jad.split_buffer_error(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(half)))
        want_blur = np.asarray(jad._dilate_blur(jnp.asarray(want_err)))
        want_extra = np.asarray(jad.budgets_from_error(
            jnp.asarray(want_err), jnp.asarray(base), 64, 0.05))
    err = ad.split_buffer_error(torch.from_numpy(a), torch.from_numpy(b),
                                torch.as_tensor(half))
    assert _ulps(err.numpy(), want_err) <= 1
    blur = ad._dilate_blur(torch.from_numpy(want_err.copy()))
    assert _ulps(blur.numpy(), want_blur) <= 1
    extra = ad.budgets_from_error(torch.from_numpy(want_err.copy()),
                                  torch.as_tensor(base), 64, 0.05)
    assert extra.dtype == torch.int32
    np.testing.assert_array_equal(extra.numpy(), want_extra)
    # the inputs reach zero budgets, the clip and many counts between
    assert int(extra.min()) == 0 and len(np.unique(extra.numpy())) > 10


def test_budgets_round_half_to_even_as_jax():
    """Budgets at round's half points (exact in f32 at tol 1): 2.5 -> 2,
    10.5 -> 10, 7.5 -> 8, as jnp.round; and the clip at max - count."""
    import jax
    import jax.numpy as jnp

    from raytracingincuda_tpu.ops import adaptive as jad

    err = np.array([[1.5, 2.5, 3.5, 4.5, 1.5, 1.5, 9.0]], np.float32)
    counts = np.array([[2, 2, 2, 2, 4, 6, 2]], np.int32)
    with jax.disable_jit():
        want = np.asarray(jad.budgets_from_error(
            jnp.asarray(err), jnp.asarray(counts), 64, 1.0, smooth=False))
    got = ad.budgets_from_error(torch.from_numpy(err),
                                torch.from_numpy(counts), 64, 1.0,
                                smooth=False).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [[2, 10, 22, 38, 5, 8, 62]]


def test_budget_formula_and_identical_buffers():
    """Twins of the JAX package's test_budget_formula and
    test_split_buffer_error_zero_for_identical."""
    extra = ad.budgets_from_error(torch.tensor([0.0, 0.05, 0.1, 10.0]), 16,
                                  64, tol=0.05, smooth=False)
    assert extra[0] == 0 and extra[1] == 0
    assert 0 < extra[2] <= 48 and extra[3] == 48
    a = torch.ones((4, 4, 3))
    assert torch.equal(ad.split_buffer_error(a, a, 2), torch.zeros((4, 4)))


@pytest.mark.parametrize("cap", [12, 240])
def test_bucket_order_matches_jax(cap):
    """The refine's pixel order at the port's padding (a multiple of 128)
    equals JAX's counting sort (_bucket_order) on the same buckets, bit
    for bit."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.ops.pallas_kernel import _bucket_order

    rng = np.random.default_rng(cap)
    extra = rng.integers(0, cap + 1, (24, 40)).astype(np.int32)
    extra[rng.random(extra.shape) < 0.4] = 0
    padded = rk.PAD * -(-extra.size // rk.PAD)
    flat = jnp.zeros((padded,), jnp.int32).at[:extra.size].set(
        jnp.asarray(extra.reshape(-1)))
    q = (flat * ad.N_BUCKETS) // max(cap, 1)
    want = _bucket_order(jnp.clip(q, 0, ad.N_BUCKETS - 1), ad.N_BUCKETS - 1)
    got = ad.bucket_order(torch.from_numpy(extra), cap, padded)
    assert got.dtype == torch.int32 and got.shape == (padded,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


def _spy_plans(monkeypatch):
    """Record every plan's budgets (the rounds' extra samples)."""
    plans = []
    real = ad.plan

    def spy(*args, **kw):
        out = real(*args, **kw)
        plans.append(out[1].clone())
        return out

    monkeypatch.setattr(ad, "plan", spy)
    return plans


def _check_invariants(res, probes_a, probes_b, rounds, max_spp=MAX):
    spp = res.spp_map
    img = res.image
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    assert spp.dtype == torch.int32
    assert int(spp.min()) >= BASE and int(spp.max()) <= max_spp
    assert int(spp.max()) > int(spp.min())          # the budget varies
    if rounds > 1:
        assert bool(((spp - BASE) % 2 == 0).all())  # two half launches
    mask = spp == BASE
    assert bool(mask.any())
    base = linear_to_gamma((probes_a + probes_b) / float(BASE))
    assert torch.equal(img[mask], base[mask])


@pytest.mark.parametrize("rounds", [1, 2])
def test_render_adaptive_matches_jax_composition(rounds, monkeypatch):
    """The plain versions' adaptive render against the JAX Pallas kernel
    in interpret mode composed at the port's own budgets: the probes, then
    each round's refines from the same sample windows. Gate: the
    cross-framework gate (XLA's fused multiply-adds flip a few knife-edge
    paths). Also the JAX tests' invariants."""
    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.models.scene import build_scene as j_build
    from raytracingincuda_tpu.ops.pallas_kernel import render_pallas

    plans = _spy_plans(monkeypatch)
    scene, cam = build_scene(2, pad_to_multiple=64, device="cpu"), \
        CameraConfig.reference_default()
    res = ad.render_adaptive(scene, cam, W, H, D, base_spp=BASE, max_spp=MAX,
                             tol=TOL, rounds=rounds)
    raw = dict(gamma=False, accumulate_only=True)
    pa = rk.render_kernel(scene, cam, W, H, BASE // 2, D, **raw)
    pb = rk.render_kernel(scene, cam, W, H, BASE // 2, D,
                          sample_offset=BASE // 2, **raw)
    _check_invariants(res, pa, pb, rounds)

    js, jc = j_build(2, pad_to_multiple=64), JCam.reference_default()

    def jrender(spp, offset, budgets=None):
        return np.asarray(render_pallas(
            js, jc, W, H, spp, D, ray_tile=128, interpret=True,
            sample_offset=offset, sample_budgets=budgets, **raw))

    assert int(plans[0].max()) > 0 and len(plans) == rounds
    a = jrender(BASE // 2, 0)
    b = jrender(BASE // 2, BASE // 2)
    for launches, extra in zip(ad.sample_windows(BASE, MAX, rounds), plans):
        if int(extra.max()) == 0:
            break
        if rounds == 1:
            (spp, off), = launches
            a = a + jrender(spp, off, extra.reshape(-1).numpy())
        else:
            half = (extra // 2).reshape(-1).numpy()
            (spp_a, off_a), (spp_b, off_b) = launches
            a = a + jrender(spp_a, off_a, half)
            b = b + jrender(spp_b, off_b, half)
    counts = BASE + sum(p.numpy() for p in plans)
    np.testing.assert_array_equal(res.spp_map.numpy(), counts)
    want = np.sqrt(np.maximum((a + b) / counts[..., None], 0.0))
    st = ppm.diff_stats(res.image.numpy(), ppm.quantize(want))
    assert ppm.passes_cross_framework_gate(st), st


def test_adaptive_on_stream_scene():
    """The stream route on a 200-sphere explicit stream (blocks of 64):
    the same image and counts as the regen kernel's route (the walk's
    winner equals the brute-force one but at exact ties between blocks),
    and the invariants against the stream probes."""
    scene, cam = build_random_scene(200, half_extent=10.0, device="cpu"), \
        CameraConfig.reference_default()
    stream = sk.prepare_stream_scene(scene, block=64)
    assert stream.n_blocks > 1
    res = ad.render_adaptive(scene, cam, W, H, D, base_spp=BASE, max_spp=MAX,
                             tol=TOL, stream=stream)
    raw = dict(gamma=False, accumulate_only=True)
    pa = sk.render_stream(stream, cam, W, H, BASE // 2, D, **raw)
    pb = sk.render_stream(stream, cam, W, H, BASE // 2, D,
                          sample_offset=BASE // 2, **raw)
    _check_invariants(res, pa, pb, 1)
    brute = ad.render_adaptive(scene, cam, W, H, D, base_spp=BASE,
                               max_spp=MAX, tol=TOL)
    assert torch.equal(res.spp_map, brute.spp_map)
    assert torch.equal(res.image, brute.image)
    with pytest.raises(ValueError, match="legacy_sky"):
        ad.render_adaptive(scene, cam, W, H, D, base_spp=BASE, stream=stream,
                           legacy_sky=True)


def test_make_renderer_routes_by_slots(monkeypatch):
    """impl='adaptive' renders up to 4096 slots on the regen kernel (no
    stream) and above on the stream kernel, over a stream of blocks of
    cfg.stream_block reordered front to back from the render's camera,
    prepared once per scene (``prepare`` ahead of the render). A spy
    stands in for the render: no 5k-sphere image is made."""
    calls, prepared = [], []
    real_prepare = sk.prepare_stream_scene

    def spy_prepare(*a, **k):
        prepared.append(k.get("block"))
        return real_prepare(*a, **k)

    def spy_render(scene, cam_cfg, *a, **k):
        calls.append((scene.num_slots, k))
        return ad.AdaptiveResult(torch.zeros((H, W, 3)), None, None)

    monkeypatch.setattr(sk, "prepare_stream_scene", spy_prepare)
    monkeypatch.setattr(ad, "render_adaptive", spy_render)
    cfg = RenderConfig(scene_id=1, width=W, height=H, samples=6, bounces=D,
                       impl="adaptive", adaptive_rounds=2, stream_block=128)
    r = make_renderer(cfg, "cpu")
    cam = CameraConfig.reference_default()
    small = build_scene(1, device="cpu")
    r.prepare(small)
    r(small, cam)
    big = build_random_scene(5000, seed=3, device="cpu")
    assert big.num_slots > 4096
    r.prepare(big)
    r(big, cam)
    r(big, cam)
    assert prepared == [128]
    (n0, kw0), (n1, kw1), _ = calls
    assert (n0, n1) == (small.num_slots, big.num_slots)
    assert kw0["stream"] is None
    assert (kw0["base_spp"], kw0["max_spp"], kw0["rounds"]) == (6, 24, 2)
    want = sk.reorder_front_to_back(real_prepare(big, block=128),
                                    initialize(cam, W, H).center)
    assert kw1["stream"].block == 128
    assert torch.equal(kw1["stream"].bounds, want.bounds)
    assert torch.equal(kw1["stream"].scene_mat, want.scene_mat)


@pytest.mark.parametrize("kw, match", [
    (dict(base_spp=5), "even"),
    (dict(base_spp=8, max_spp=4), "max_spp"),
    (dict(rounds=0), "rounds"),
])
def test_render_adaptive_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        ad.render_adaptive(build_scene(2, device="cpu"),
                           CameraConfig.reference_default(), W, H, 2, **kw)


def test_adaptive_refusals_and_config():
    scene, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    with pytest.raises(TypeError, match="Mesh"):
        ad.render_adaptive(scene, cam, W, H, 2, mesh=object())
    with pytest.raises(ValueError, match="counter field"):
        ad.render_adaptive(scene, cam, W, H, 2, base_spp=16,
                           max_spp=2 ** 20, rounds=2)
    cfg = RenderConfig(scene_id=1, samples=6, impl="adaptive")
    assert cfg.effective_max_samples == 24
    assert RenderConfig(scene_id=1, max_samples=10).effective_max_samples == 10
    for bad in (dict(samples=3), dict(max_samples=4), dict(adaptive_rounds=0),
                dict(adaptive_tol=0.0), dict(dtype="float64")):
        with pytest.raises(ValueError):
            RenderConfig(scene_id=1, impl="adaptive", **bad)


def test_make_renderer_adaptive_image():
    """The renderer's image is render_adaptive's (gamma), on the regen
    kernel's plain version."""
    cfg = RenderConfig(scene_id=2, width=W, height=H, samples=BASE,
                       bounces=D, impl="adaptive", max_samples=MAX,
                       adaptive_tol=TOL)
    scene, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    want = ad.render_adaptive(scene, cam, W, H, D, base_spp=BASE,
                              max_spp=MAX, tol=TOL).image
    assert torch.equal(make_renderer(cfg, "cpu")(scene, cam), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [1, 2])
def test_adaptive_card_equals_plain(cuda, rounds):
    """The card's adaptive render (kernel 1, and kernel 4 on an explicit
    stream) equals the plain versions' bit for bit, images and counts."""
    cam = CameraConfig.reference_default()
    kw = dict(base_spp=BASE, max_spp=MAX, tol=TOL, rounds=rounds)
    got = ad.render_adaptive(build_scene(1, device=cuda), cam, 64, 40, D,
                             **kw)
    want = ad.render_adaptive(build_scene(1, device="cpu"), cam, 64, 40, D,
                              **kw)
    assert torch.equal(got.image.cpu(), want.image)
    assert torch.equal(got.spp_map.cpu(), want.spp_map)
    small = build_random_scene(200, half_extent=10.0, device="cpu")
    st = sk.prepare_stream_scene(small, block=64)
    st_card = sk.StreamScene(st.scene_mat.to(cuda), st.bounds.to(cuda),
                             st.block, st.perm.to(cuda))
    got = ad.render_adaptive(build_random_scene(200, half_extent=10.0,
                                                device=cuda), cam, 64, 40,
                             D, stream=st_card, **kw)
    want = ad.render_adaptive(small, cam, 64, 40, D, stream=st, **kw)
    assert torch.equal(got.image.cpu(), want.image)
    assert torch.equal(got.spp_map.cpu(), want.spp_map)
