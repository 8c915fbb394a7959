"""The regeneration kernel's module: plain version, plumbing and prepass.

On the CPU ``render_kernel`` runs the kernel's plain PyTorch version
(``regen_reference``); the tests hold it to the JAX Pallas kernel in
interpret mode at one 128-lane tile, to the production goldens (which
that kernel rendered) and to its own invariants. XLA compiles interpret
mode, fusing multiply-adds, so images use the cross-framework gate of
``utils/ppm.py`` and prepass segments must agree on >= 95% of lanes. The
``cuda`` tests hold the CUDA kernel to the plain version on the card, bit
for bit; they skip without a card. JAX is imported inside the tests that
compare with it, so that the card's machine, which has no JAX, can run
the ``cuda`` tests: ``pytest --noconftest -m cuda`` on this file.
"""
import os

import numpy as np
import pytest
import torch

from raytracingincuda_torch.config import RenderConfig
from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.scene import build_scene as t_build
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import tracer as ttr
from raytracingincuda_torch.render_api import make_renderer
from raytracingincuda_torch.utils import ppm, trace

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
W, H = 16, 8  # one 128-lane tile on both sides


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def _pallas(scene_id, spp, depth, **kw):
    """The JAX Pallas kernel in interpret mode at one 128-lane tile."""
    from raytracingincuda_tpu.models.camera import CameraConfig
    from raytracingincuda_tpu.models.scene import build_scene
    from raytracingincuda_tpu.ops.pallas_kernel import render_pallas

    return render_pallas(build_scene(scene_id),
                         CameraConfig.reference_default(), W, H, spp, depth,
                         ray_tile=128, interpret=True, **kw)


@pytest.mark.parametrize("scene_id", [1, 2, 3])
def test_plain_version_matches_production_golden(scene_id):
    """The production stack (prepass, difficulty order, rr2) through
    make_renderer on the CPU, against the JAX kernel's own output."""
    cfg = RenderConfig(scene_id=scene_id, width=64, height=40, samples=8,
                       bounces=6, rr_start=2)
    img = make_renderer(cfg, "cpu")(t_build(scene_id, device="cpu"),
                                    TCam.reference_default())
    golden, _ = ppm.read_ppm(os.path.join(
        GOLDEN_DIR, f"scene{scene_id}_prod_64x40_8spp_6b_rr2.ppm"))
    st = ppm.diff_stats(img.numpy(), golden)
    assert ppm.passes_cross_framework_gate(st), st


def test_plain_version_vs_pallas_radiance_rr2():
    want = np.asarray(_pallas(1, 4, 6, rr_start=2))
    got = rk.render_kernel(t_build(1, device="cpu"),
                           TCam.reference_default(), W, H, 4, 6,
                           rr_start=2).numpy()
    st = ppm.diff_stats(got, ppm.quantize(want))
    assert ppm.passes_cross_framework_gate(st), st


def test_plain_version_vs_pallas_segments():
    _, seg = _pallas(1, 6, 8, gamma=False, return_depth=True)
    got = rk.measure_difficulty(t_build(1, device="cpu"),
                                TCam.reference_default(), W, H, 8, 6)
    assert got.shape == (W * H,)
    assert (got.numpy() == np.asarray(seg)).mean() >= 0.95


def test_plain_version_vs_pallas_budgets_accumulate_only():
    """Two budget groups (1 and 3 samples from sample_offset 2), raw sums
    normalized per pixel."""
    nb = np.where(np.arange(W * H) % 2 == 0, 1, 3).astype(np.int32)
    kw = dict(sample_offset=2, accumulate_only=True, gamma=False)
    want = np.asarray(_pallas(2, 3, 6, sample_budgets=nb, **kw))
    got = rk.render_kernel(t_build(2, device="cpu"),
                           TCam.reference_default(), W, H, 3, 6,
                           sample_budgets=torch.from_numpy(nb), **kw).numpy()
    per = nb.reshape(H, W, 1).astype(np.float32)
    st = ppm.diff_stats(np.sqrt(got / per), ppm.quantize(np.sqrt(want / per)))
    assert ppm.passes_cross_framework_gate(st), st


def test_budgets_and_offsets_add_up_exactly():
    """Sample ids are global counters: per-pixel passes [0, 2) and [2, 4)
    sum to the one-pass raw sum."""
    s, cam = t_build(2, device="cpu"), TCam.reference_default()
    kw = dict(accumulate_only=True, gamma=False)
    full = rk.render_kernel(s, cam, W, H, 4, 5, **kw)
    a = rk.render_kernel(s, cam, W, H, 2, 5, **kw)
    b = rk.render_kernel(s, cam, W, H, 2, 5, sample_offset=2, **kw)
    torch.testing.assert_close(a + b, full, rtol=1e-6, atol=1e-6)
    two = torch.full((W * H,), 2)
    same = rk.render_kernel(s, cam, W, H, 2, 5, sample_budgets=two, **kw)
    assert torch.equal(same, a)


def test_difficulty_order_bit_equal_to_jax():
    import jax.numpy as jnp

    from raytracingincuda_tpu.ops import pallas_kernel as jpk

    rng = np.random.default_rng(0)
    seg = rng.integers(0, 60, 4096).astype(np.float32)
    for probe_depth, probe_samples in ((8, 6), (3, 2)):
        want = np.asarray(jpk.difficulty_order(jnp.asarray(seg), probe_depth,
                                               probe_samples))
        got = rk.difficulty_order(torch.from_numpy(seg), probe_depth,
                                  probe_samples)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    real = rk.measure_difficulty(t_build(1, device="cpu"),
                                 TCam.reference_default(), 32, 24)
    want = np.asarray(jpk.difficulty_order(jnp.asarray(real.numpy())))
    np.testing.assert_array_equal(rk.difficulty_order(real).numpy(), want)


def test_legacy_sky_vs_eager_jax_oracle():
    import jax

    from raytracingincuda_tpu.models.camera import CameraConfig
    from raytracingincuda_tpu.models.scene import build_scene
    from raytracingincuda_tpu.ops import tracer as jtr

    with jax.disable_jit():
        want = np.asarray(jtr.render(build_scene(2),
                                     CameraConfig.reference_default(), W, H,
                                     2, 6, legacy_sky=True))
    got = rk.render_kernel(t_build(2, device="cpu"),
                           TCam.reference_default(), W, H, 2, 6,
                           legacy_sky=True).numpy()
    st = ppm.diff_stats(got, ppm.quantize(want))
    assert ppm.passes_golden_gate(st), st
    plain = rk.render_kernel(t_build(2, device="cpu"),
                             TCam.reference_default(), W, H, 2, 6)
    assert not torch.equal(plain, torch.from_numpy(got))


def test_pixel_order_and_layout_change_nothing():
    s, cam = t_build(3, device="cpu"), TCam.reference_default()
    base = rk.render_kernel(s, cam, 24, 16, 2, 6, rr_start=2)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(384))
    assert torch.equal(base, rk.render_kernel(s, cam, 24, 16, 2, 6,
                                              rr_start=2, pixel_order=perm))
    assert torch.equal(base, rk.render_kernel(s, cam, 24, 16, 2, 6,
                                              rr_start=2, layout="hbm"))


def test_wrapper_checks_raise():
    s, cam = t_build(2, device="cpu"), TCam.reference_default()
    ids, ii, jj, bud, sm, row = rk.regen_inputs(s, cam, W, H, 2)
    kw = dict(samples=2, max_depth=4)
    with pytest.raises(TypeError):
        rk.regen_reference(ids.long(), ii, jj, bud, sm, row, **kw)
    with pytest.raises(ValueError):
        rk.regen_reference(ids[:100], ii[:100], jj[:100], bud[:100], sm,
                           row, **kw)
    with pytest.raises(ValueError):
        rk.regen_reference(ids, ii, jj, bud, sm[:, :11], row, **kw)
    with pytest.raises(ValueError):
        rk.regen_reference(ids, ii, jj, bud, sm, row, layout="packed", **kw)
    big = torch.zeros((rk.MAX_VMEM_SLOTS + 1, rk.NUM_COLS))
    with pytest.raises(ValueError):
        rk.regen_reference(ids, ii, jj, bud, big, row, **kw)
    with pytest.raises(ValueError):
        rk.regen_kernel(ids, ii, jj, bud, sm, row, **kw)  # CPU tensors
    with pytest.raises(ValueError):
        rk.render_kernel(s, cam, W, H, 2, 4, sample_budgets=torch.full(
            (W * H,), 3))
    with pytest.raises(ValueError):
        rk.render_kernel(s, cam, W, H, 2, 4,
                         pixel_order=torch.arange(W * H + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("rr_start", [None, 2])
@pytest.mark.parametrize("layout", ["vmem", "hbm"])
def test_kernel_equals_plain_version_on_card(cuda, rr_start, layout):
    s = t_build(1, device=cuda)
    inputs = rk.regen_inputs(s, TCam.reference_default(), 64, 40, 4)
    kw = dict(samples=4, max_depth=12, rr_start=rr_start, layout=layout,
              finalize_scale=0.25)
    before = trace.counts().get("launch.regen_render", 0)
    got = rk.regen_kernel(*inputs, **kw)
    torch.cuda.synchronize()
    assert trace.counts().get("launch.regen_render", 0) == before + 1
    assert torch.equal(got, rk.regen_reference(*inputs, **kw))
    cpu = rk.regen_reference(*(t.cpu() for t in inputs), **kw)
    assert torch.equal(got.cpu(), cpu)
    seg = dict(samples=4, max_depth=8, emit_depth=True, layout=layout)
    assert torch.equal(rk.regen_kernel(*inputs, **seg),
                       rk.regen_reference(*inputs, **seg))


@pytest.mark.cuda
@pytest.mark.parametrize("scene_id", [1, 2, 3])
def test_kernel_matches_goldens_on_card(cuda, scene_id):
    cam = TCam.reference_default()
    img = rk.render_kernel(t_build(scene_id, device=cuda), cam, 48, 30, 4, 8)
    golden, _ = ppm.read_ppm(
        os.path.join(GOLDEN_DIR, f"scene{scene_id}_48x30_4spp_8b.ppm"))
    st = ppm.diff_stats(img.cpu().numpy(), golden)
    assert ppm.passes_cross_framework_gate(st), st
    cpu = ttr.render(t_build(scene_id, device="cpu"), cam, 48, 30, 4, 8)
    assert torch.equal(img.cpu(), cpu)


def _budgets(seed, top):
    return np.random.default_rng(seed).integers(0, top + 1, W * H)


@pytest.mark.parametrize("rr_start", [None, 2])
def test_plain_counts_vs_segments_and_pallas(rr_start):
    """The count mode's plain version at the prepass test's shape, with
    per-pixel budgets: its lane totals are the plain render's emit_depth
    segments bit for bit; its warp iterations, from per-sample segments,
    are the regenerating warp's longest lane (at most the per-sample wait
    of the nested loop); and the same counts from the JAX kernel's
    per-sample segments (interpret mode, so XLA's fused multiply-adds can
    end a path at another bounce, as in the prepass test) agree."""
    spp, depth = 4, 8
    nb = _budgets(3, spp)
    inputs = rk.regen_inputs(t_build(1, device="cpu"),
                             TCam.reference_default(), W, H, spp,
                             sample_budgets=torch.from_numpy(nb))
    kw = dict(samples=spp, max_depth=depth, rr_start=rr_start)
    seg, regen, *_ = rk.regen_counts_reference(*inputs, **kw)
    per = rk.sample_segments(*inputs, **kw)
    nested = rk.warp_iterations(per, "nested")
    want = rk.regen_reference(*inputs, emit_depth=True, **kw)[0]
    assert torch.equal(seg, want) and torch.equal(per.sum(0), want)
    assert torch.equal(regen.double(), seg.double().view(-1, rk.WARP).amax(1))
    assert bool((nested >= regen).all()) and bool((nested > regen).any())
    per_jax = np.stack([np.asarray(_pallas(1, 1, depth, gamma=False,
                                       return_depth=True, sample_offset=s,
                                       sample_budgets=(nb > s).astype(np.int32),
                                       rr_start=rr_start)[1])
                    for s in range(spp)])
    jax_seg = torch.from_numpy(per_jax.astype(np.float32))
    assert (jax_seg.sum(0) == seg).float().mean() >= 0.95
    for loop, mine in (("regen", regen.double()), ("nested", nested)):
        theirs = rk.warp_iterations(jax_seg, loop)
        rel = (theirs - mine).abs() / mine
        assert float(rel.max()) <= 0.1, (loop, theirs, mine)


def test_warp_iterations_by_hand():
    """Two warps, three samples: per-lane totals and per-sample maxima."""
    seg = torch.zeros((3, 2 * rk.WARP))
    seg[:, 0] = torch.tensor([1.0, 5.0, 1.0])     # warp 0: one long lane
    seg[:, 1] = torch.tensor([4.0, 1.0, 4.0])
    seg[:, rk.WARP:] = 2.0                        # warp 1: all equal
    assert rk.warp_iterations(seg).tolist() == [9.0, 6.0]
    assert rk.warp_iterations(seg, "nested").tolist() == [13.0, 6.0]
    with pytest.raises(ValueError):
        rk.warp_iterations(seg, "wave")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vmem", "hbm"])
def test_kernel_equals_plain_legacy_budgets_prepass_on_card(cuda, layout):
    """The regenerating loop against the plain version with legacy_sky, with
    per-pixel budgets from a sample offset, and as the prepass."""
    s, cam = t_build(1, device=cuda), TCam.reference_default()
    inputs = rk.regen_inputs(s, cam, 64, 40, 4)
    kw = dict(samples=4, max_depth=10, legacy_sky=True, layout=layout)
    assert torch.equal(rk.regen_kernel(*inputs, **kw),
                       rk.regen_reference(*inputs, **kw))
    nb = torch.from_numpy(np.random.default_rng(4).integers(0, 5, 64 * 40))
    inputs = rk.regen_inputs(s, cam, 64, 40, 4, sample_offset=3,
                             sample_budgets=nb)
    for extra in (dict(rr_start=2), dict(emit_depth=True)):
        kw = dict(samples=4, max_depth=10, sample_offset=3, layout=layout,
                  **extra)
        assert torch.equal(rk.regen_kernel(*inputs, **kw),
                           rk.regen_reference(*inputs, **kw))
    seg = rk.measure_difficulty(s, cam, 64, 40, 8, 6, layout=layout)
    assert torch.equal(seg.cpu(), rk.measure_difficulty(
        t_build(1, device="cpu"), cam, 64, 40, 8, 6, layout=layout))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vmem", "hbm"])
@pytest.mark.parametrize("rr_start", [None, 2])
def test_count_mode_equals_plain_count_on_card(cuda, layout, rr_start):
    """The card's hit-test issues per warp equal the plain count from
    per-sample segments: the regenerating loop's warps issue the scan once
    for each segment of their longest lane. Its groups opened and slot
    tests per warp equal the plain count's (the two-level scan's vote wave
    by wave in layout 'vmem'; every slot a scan in 'hbm')."""
    nb = torch.from_numpy(np.random.default_rng(5).integers(0, 7, 64 * 40))
    inputs = rk.regen_inputs(t_build(1, device=cuda), TCam.reference_default(),
                             64, 40, 6, sample_budgets=nb)
    kw = dict(samples=6, max_depth=12, rr_start=rr_start, layout=layout)
    seg, issues, opened, tests = rk.regen_counts(*inputs, **kw)
    p_seg, p_iter, p_opened, p_tests = rk.regen_counts_reference(*inputs, **kw)
    assert torch.equal(seg, p_seg)
    assert torch.equal(issues, p_iter)
    assert torch.equal(opened.cpu(), p_opened.cpu())
    assert torch.equal(tests.cpu(), p_tests.cpu())
    assert bool((opened > 0).any()) == (layout == "vmem")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cover", "tie", "random2000"])
def test_two_level_scan_equals_plain_version_on_card(cuda, name, monkeypatch):
    """Kernel 1 scanning in two levels (layout 'vmem', a group table a
    launch) against the plain version bit for bit, at parity, at rr2 and as
    the prepass, and against the same launches scanning in one level; its
    count mode's groups and slot tests equal the plain count's."""
    from group_scenes import one_level, scene_named

    inputs = rk.regen_inputs(scene_named(name, cuda), TCam.reference_default(),
                             64, 40, 4)
    cases = (dict(samples=4, max_depth=12, finalize_scale=0.25),
             dict(samples=4, max_depth=12, rr_start=2),
             dict(samples=4, max_depth=8, emit_depth=True))
    two = []
    for kw in cases:
        before = trace.counts().get("scan.two_level", 0)
        two.append(rk.regen_kernel(*inputs, **kw))
        torch.cuda.synchronize()
        assert trace.counts().get("scan.two_level", 0) == before + 1
        assert torch.equal(two[-1], rk.regen_reference(*inputs, **kw))
    kw = dict(samples=4, max_depth=8, rr_start=2)
    counts = rk.regen_counts(*inputs, **kw)
    want = rk.regen_counts_reference(*inputs, **kw)
    for a, b in zip(counts, want):
        assert torch.equal(a.cpu(), b.cpu())
    one_level(monkeypatch)
    for kw, got in zip(cases, two):
        assert torch.equal(got, rk.regen_kernel(*inputs, **kw))
