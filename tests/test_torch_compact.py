"""The older render schedules: ``render_kernel(mode='compact' | 'simple')``.

``'compact'`` is live-ray compaction (``ops/compact_kernel.py``); on the
CPU it runs the kernel's plain version (``compact_reference``).
``'simple'`` runs the regeneration kernel. The tests hold both to the JAX
Pallas kernels in interpret mode under the cross-framework gate of
``utils/ppm.py`` (XLA fuses multiply-adds there), to the port's
``mode='regen'`` bit for bit, and to JAX's mode rules. The scene is JAX
scene 2 (``tiny_scene``'s build) carried across with ``models/convert.py``.
The ``cuda`` test holds the CUDA kernel to its plain version and to
kernel 1 on the card, at the schedule's edge cases too; they skip
without a card. The count tests hold ``warp_iterations``' block schedules
('compact', 'pool') to a wave-by-wave simulation of the two pools.
"""
import math

import numpy as np
import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.convert import (camera_config_from_numpy,
                                                   scene_from_numpy)
from raytracingincuda_torch.models.scene import DIELECTRIC, Scene
from raytracingincuda_torch.models.scene import build_scene as t_build
from raytracingincuda_torch.ops import compact_kernel as ck
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.utils import ppm, trace

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

W, H, SPP, DEPTH = 32, 16, 2, 5  # four 128-lane tiles on the JAX side


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def _carried(tiny_scene, default_camera):
    import jax

    leaves = lambda t: [np.asarray(x)  # noqa: E731
                        for x in jax.tree_util.tree_leaves(t)]
    return (scene_from_numpy(leaves(tiny_scene), device="cpu"),
            camera_config_from_numpy(leaves(default_camera)))


@pytest.mark.parametrize("mode", ["compact", "simple"])
def test_plain_version_vs_pallas(mode, tiny_scene, default_camera):
    from raytracingincuda_tpu.ops.pallas_kernel import render_pallas

    want = np.asarray(render_pallas(tiny_scene, default_camera, W, H, SPP,
                                    DEPTH, ray_tile=128, interpret=True,
                                    mode=mode))
    got = rk.render_kernel(*_carried(tiny_scene, default_camera), W, H, SPP,
                           DEPTH, mode=mode).numpy()
    st = ppm.diff_stats(got, ppm.quantize(want))
    assert ppm.passes_cross_framework_gate(st), st


@pytest.mark.parametrize("mode, kw", [
    ("compact", {}),
    ("simple", {}),
    ("simple", dict(legacy_sky=True)),
    ("compact", dict(layout="hbm", gamma=False)),
    ("compact", dict(accumulate_only=True)),
])
def test_modes_equal_regen_bit_for_bit(mode, kw, tiny_scene, default_camera):
    scene, cam = _carried(tiny_scene, default_camera)
    want = rk.render_kernel(scene, cam, W, H, SPP, DEPTH, **kw)
    assert torch.equal(rk.render_kernel(scene, cam, W, H, SPP, DEPTH,
                                        mode=mode, **kw), want)


def test_compact_pixel_order_changes_nothing():
    s, cam = t_build(1, device="cpu"), TCam.reference_default()
    base = rk.render_kernel(s, cam, 24, 16, 2, 8)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(384))
    assert torch.equal(base, rk.render_kernel(s, cam, 24, 16, 2, 8,
                                              mode="compact",
                                              pixel_order=perm))


def test_compact_reference_equals_regen_reference():
    """The plain versions on the same lanes, raw sums and the fused
    finalize, with lanes split over several pools."""
    s, cam = t_build(3, device="cpu"), TCam.reference_default()
    ids, ii, jj, bud, sm, row = rk.regen_inputs(s, cam, 40, 16, 3)
    for scale in (None, 1.0 / 3):
        want = rk.regen_reference(ids, ii, jj, bud, sm, row, samples=3,
                                  max_depth=6, finalize_scale=scale)
        got = ck.compact_reference(ids, ii, jj, sm, row, samples=3,
                                   max_depth=6, finalize_scale=scale)
        assert torch.equal(got, want)


def test_compact_with_legacy_sky_runs_simple(monkeypatch):
    """As in JAX: compact has no legacy-sky rows, so it runs 'simple'."""
    s, cam = t_build(2, device="cpu"), TCam.reference_default()
    monkeypatch.setattr(ck, "render_compact", lambda *a, **k: pytest.fail(
        "compact ran with legacy_sky"))
    got = rk.render_kernel(s, cam, 16, 8, 2, 5, mode="compact",
                           legacy_sky=True)
    assert torch.equal(got, rk.render_kernel(s, cam, 16, 8, 2, 5,
                                             legacy_sky=True))


@pytest.mark.parametrize("mode", ["compact", "simple"])
@pytest.mark.parametrize("kw, match", [
    (dict(return_depth=True), "return_depth requires mode='regen'"),
    (dict(sample_offset=2), "require mode='regen'"),
    (dict(sample_budgets=torch.ones(128, dtype=torch.int32)),
     "require mode='regen'"),
    (dict(rr_start=2), "rr_start requires mode='regen'"),
])
def test_mode_rules_raise(mode, kw, match):
    s, cam = t_build(2, device="cpu"), TCam.reference_default()
    with pytest.raises(ValueError, match=match):
        rk.render_kernel(s, cam, 16, 8, 2, 4, mode=mode, **kw)


def test_wrapper_checks_raise():
    s, cam = t_build(2, device="cpu"), TCam.reference_default()
    with pytest.raises(ValueError, match="mode"):
        rk.render_kernel(s, cam, 16, 8, 2, 4, mode="wavefront")
    ids, ii, jj, _, sm, row = rk.regen_inputs(s, cam, 16, 8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ck.compact_kernel(ids, ii, jj, sm, row, samples=2, max_depth=4)
    with pytest.raises(ValueError):
        ck.compact_reference(ids, ii, jj, sm, row, samples=2, max_depth=4,
                             layout="packed")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vmem", "hbm"])
def test_kernel_equals_plain_version_and_kernel_1_on_card(cuda, layout):
    s = t_build(1, device=cuda)
    ids, ii, jj, bud, sm, row = rk.regen_inputs(s, TCam.reference_default(),
                                                72, 40, 3)
    kw = dict(samples=3, max_depth=12, layout=layout, finalize_scale=1 / 3)
    before = trace.counts().get("launch.compact_render", 0)
    got = ck.compact_kernel(ids, ii, jj, sm, row, **kw)
    torch.cuda.synchronize()
    assert trace.counts().get("launch.compact_render", 0) == before + 1
    assert torch.equal(got, ck.compact_reference(ids, ii, jj, sm, row, **kw))
    assert torch.equal(got, rk.regen_kernel(ids, ii, jj, bud, sm, row, **kw))
    assert torch.equal(got, ck.compact_kernel(ids, ii, jj, sm, row, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cover", "tie", "random2000"])
def test_two_level_scan_in_compact_kernel_on_card(cuda, name, monkeypatch):
    """Kernel 7 scanning in two levels (its lanes in the scan vote on each
    group) against its plain version and kernel 1, bit for bit, and against
    its own launch scanning in one level."""
    from group_scenes import one_level, scene_named

    ids, ii, jj, bud, sm, row = rk.regen_inputs(
        scene_named(name, cuda), TCam.reference_default(), 72, 40, 3)
    kw = dict(samples=3, max_depth=12, finalize_scale=1 / 3)
    before = trace.counts().get("scan.two_level", 0)
    got = ck.compact_kernel(ids, ii, jj, sm, row, **kw)
    torch.cuda.synchronize()
    assert trace.counts().get("scan.two_level", 0) == before + 1
    assert torch.equal(got, ck.compact_reference(ids, ii, jj, sm, row, **kw))
    assert torch.equal(got, rk.regen_kernel(ids, ii, jj, bud, sm, row, **kw))
    one_level(monkeypatch)
    assert torch.equal(got, ck.compact_kernel(ids, ii, jj, sm, row, **kw))


def test_block_schedules_by_hand():
    """One block of 64 lanes, three samples: the per-sample pool waits for
    each sample's longest path, the refilling pool for the longest total."""
    seg = torch.zeros((3, 2 * rk.WARP))
    seg[:, 0] = torch.tensor([1.0, 5.0, 1.0])
    seg[:, 1] = torch.tensor([4.0, 1.0, 4.0])
    seg[:, rk.WARP:] = 2.0
    # sample 0: waves of 34, 33, 1, 1 live lanes; 1: 34, 33, 1, 1, 1;
    # 2: as 0
    assert rk.warp_iterations(seg, "compact").tolist() == [19.0]
    # waves 0-5: 34 live (2 warps), 6: lanes 0 and 1, 7-8: lane 1
    assert rk.warp_iterations(seg, "pool").tolist() == [15.0]
    # a full block of one-segment samples first, then those 64 lanes
    two = torch.ones((3, rk.POOL + 2 * rk.WARP))
    two[:, rk.POOL:] = seg
    full = 3.0 * rk.POOL / rk.WARP
    assert rk.warp_iterations(two, "compact").tolist() == [full, 19.0]
    assert rk.warp_iterations(two, "pool").tolist() == [full, 15.0]


def _simulate(seg, refill):
    """(warp issues, waves) of one block's pool, wave by wave: each live
    lane runs one segment a wave, and the live lanes fill the first
    ceil(live / 32) warps. ``refill``: a lane whose path ended starts its
    next sample in the next wave; else each sample's rays enter together
    and the next sample starts when the last of them ends."""
    samples, lanes = seg.shape
    issues = waves = 0
    for group in ([list(range(samples))] if refill
                  else [[s] for s in range(samples)]):
        left = {k: [int(seg[s, k]) for s in group] for k in range(lanes)}
        live = list(range(lanes))
        while live:
            waves += 1
            issues += math.ceil(len(live) / rk.WARP)
            for k in live:
                left[k][0] -= 1
                if left[k][0] == 0:
                    left[k].pop(0)
            live = [k for k in live if left[k]]
    return issues, waves


def test_block_schedules_on_plain_segments():
    """Kernel 1's plain per-sample segments over 1920 lanes (a last block
    of 128 where blocks take 256): both closed forms equal the
    simulation; the refilling pool takes as many waves as its longest
    lane's total, and on these paths issues no more than the per-sample
    pool in every block (not a law: on made-up segments it can issue one
    warp scan more)."""
    spp = 6
    inputs = rk.regen_inputs(t_build(1, device="cpu"),
                             TCam.reference_default(), 48, 40, spp)
    seg = rk.sample_segments(*inputs, samples=spp, max_depth=12)
    assert seg.shape == (spp, 1920) and bool((seg >= 1).all())
    compact = rk.warp_iterations(seg, "compact")
    pool = rk.warp_iterations(seg, "pool")
    blocks = -(-1920 // rk.POOL)
    assert compact.shape == pool.shape == (blocks,)
    for blk in range(blocks):
        part = seg[:, blk * rk.POOL:(blk + 1) * rk.POOL].long()
        sim_pool, waves = _simulate(part, refill=True)
        sim_compact, _ = _simulate(part, refill=False)
        assert (sim_pool, sim_compact) == (pool[blk], compact[blk])
        assert waves == int(part.sum(0).max())
    assert bool((pool <= compact).all()) and bool((pool < compact).any())


def _glass(scene):
    """Every sphere but the ground dielectric: long paths."""
    mat = scene.mat_type.clone()
    mat[1:] = DIELECTRIC
    ior = torch.full_like(scene.params.ior, 1.5)
    return Scene(scene.params._replace(ior=ior), mat, scene.active)


# (scene, width, height, spp, depth): every path ends at bounce 0 and the
# pool refills every wave; one sample; 16 samples at 640 lanes (not a
# multiple of 256); long paths through glass
EDGE_CASES = {"depth1": (1, 64, 40, 4, 1), "spp1": (1, 64, 40, 1, 25),
              "partial_block": (1, 40, 16, 16, 8), "glass": (0, 48, 32, 4, 50)}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vmem", "hbm"])
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_kernel_edge_cases_on_card(cuda, case, layout):
    sid, w, h, spp, depth = EDGE_CASES[case]
    s = _glass(t_build(1, device=cuda)) if sid == 0 else t_build(sid,
                                                                 device=cuda)
    ids, ii, jj, bud, sm, row = rk.regen_inputs(s, TCam.reference_default(),
                                                w, h, spp)
    kw = dict(samples=spp, max_depth=depth, layout=layout)
    got = ck.compact_kernel(ids, ii, jj, sm, row, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.compact_reference(ids, ii, jj, sm, row, **kw))
    assert torch.equal(got, rk.regen_kernel(ids, ii, jj, bud, sm, row, **kw))
    assert torch.equal(got, ck.compact_kernel(ids, ii, jj, sm, row, **kw))
