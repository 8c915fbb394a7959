"""The two-level closest-hit scan (ops/group_scan.py, csrc/group_table.cu,
csrc/path_common.cuh's ScanHit).

On the CPU: the group table's plain twin and its invariants, and the plain
f32 model of the kernel's scan (``model_scan``) against the brute-force
scan (``hit_world``): on the plain render's rays at the headline, on rays
that graze a member at its group bound's edge, on far and degenerate rays,
and on a scene whose duplicate spheres sit in two groups (the lower slot
wins the exact tie). The ``cuda`` tests hold the card's table to the twin
word for word and count the scan each launch ran; ``pytest --noconftest -m
cuda`` runs them on the card.
"""
import numpy as np
import pytest
import torch

from group_scenes import EYE, groups_of, tie_scene
from raytracingincuda_torch.models.camera import CameraConfig, initialize
from raytracingincuda_torch.models.scene import (build_deep_scene,
                                                 build_random_scene,
                                                 build_scene)
from raytracingincuda_torch.ops import group_scan as gs
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops.intersect import hit_world
from raytracingincuda_torch.ops.vec import Vec3
from raytracingincuda_torch.utils import trace

torch.set_num_threads(1)

W, H = 1280, 768


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def _cam(w=W, h=H):
    return rk.pack_camera(initialize(CameraConfig.reference_default(), w, h))


SCENES = {
    "cover": lambda dev: build_scene(1, device=dev),
    "scene2": lambda dev: build_scene(2, device=dev),
    "random2000": lambda dev: build_random_scene(2000, device=dev),
    "tie": lambda dev: tie_scene(dev)[0],
}


def _table(name):
    sm = rk.pack_scene_matrix(SCENES[name]("cpu"))
    return sm, gs.unpack(gs.group_table_reference(sm, _cam()), sm.shape[0])


def _check(table, scene, o, d, active=None):
    """model_scan against hit_world on every ray of ``active``."""
    if active is None:
        active = torch.ones(o.x.shape, dtype=torch.bool)
    got = gs.model_scan(table, o, d, active)
    want = hit_world(scene, o, d)
    a = active
    assert torch.equal(got.hit[a], want.hit[a])
    assert torch.equal(got.t[a], want.t[a])
    assert torch.equal(got.idx[a][want.hit[a]], want.idx[a][want.hit[a]])
    return got


def test_constants_and_path_rule():
    """The constants come from the source; the launch's rule from the slot
    count and the layout alone."""
    src = (gs._CSRC / "path_common.cuh").read_text()
    assert f"constexpr int kGroup = {gs.GROUP};" in src
    assert gs.GROUP in (8, 16) and gs.PAD == 2.0 ** -7 and gs.SAFE == 2.0 ** 40
    n_min = 2 * gs.GROUP
    for n, layout, want in ((512, "vmem", True), (n_min, "vmem", True),
                            (n_min - 1, "vmem", False), (512, "hbm", False),
                            (gs.MAX_SLOTS, "vmem", True),
                            (gs.MAX_SLOTS + 1, "vmem", False)):
        assert gs.uses_groups(n, layout) == want, (n, layout)
    assert gs.table_words(512) == (gs.HEAD + 4 * gs.entries(512)
                                   + 4 * gs.bounds(512) + gs.entries(512))


@pytest.mark.parametrize("name", list(SCENES))
def test_table_twin_invariants(name):
    """The large slots are the active ones above kLargeScale x the median
    radius, in slot order; the groups partition the other active slots,
    each member inside its group's bound, Morton-sorted within and across
    groups; the groups walk front to back from the camera."""
    sm, t = _table(name)
    act = (sm[:, rk.COL_ACTIVE] > 0.5).numpy()
    r = sm[:, rk.COL_RADIUS].abs().numpy()
    med = np.sort(r[act])[(act.sum() - 1) // 2]
    large = np.flatnonzero(act & (r > np.float32(gs.LARGE_SCALE) * med))
    assert t.large == len(large) and t.n_large == (len(large) + 3) // 4 * 4
    assert t.slot[:t.large].tolist() == large.tolist()
    assert bool((t.slot[t.large:t.n_large] == -1).all())
    members = t.slot[t.n_large:t.n_large + t.n_groups * gs.GROUP]
    real = members[members >= 0].tolist()
    assert sorted(real) == sorted(set(np.flatnonzero(act).tolist())
                                  - set(large.tolist()))
    assert t.small == len(real) and t.n_groups == -(-len(real) // gs.GROUP)
    c = sm[:, 0:3].double()
    for g in range(t.n_groups):
        ks = [k for k in members[g * gs.GROUP:(g + 1) * gs.GROUP].tolist()
              if k >= 0]
        b = t.bound[g].double()
        reach = (c[ks] - b[:3]).norm(dim=1) + torch.from_numpy(r[ks]).double()
        assert float(reach.max()) < float(b[3])
    key = [float(np.linalg.norm(t.bound[g, :3].double().numpy() - EYE)
                 - t.bound[g, 3]) for g in range(t.n_groups)]
    assert all(x <= y + 1e-5 for x, y in zip(key, key[1:]))
    ent = t.entry[t.slot >= 0]
    k = t.slot[t.slot >= 0]
    assert torch.equal(ent[:, :3], sm[k, 0:3])


def _headline_rays(rows, samples, rr):
    ids = torch.cat([torch.arange(W, dtype=torch.int32) + r * W
                     for r in rows])
    fi = (ids % W).float()
    fj = torch.div(ids, W, rounding_mode="floor").float()
    return ids, fi, fj, torch.full(ids.shape, float(samples))


@pytest.mark.parametrize("rr", [None, 2])
def test_model_equals_brute_force_on_headline_rays(rr):
    """Every wave of the plain render's rays at the headline (two rows, 2
    samples, 25 bounces): the two-level scan's slot and t are hit_world's,
    and it tests under half of the 512 slots a warp iteration."""
    scene = build_scene(1, device="cpu")
    sm, t = _table("cover")
    tests = iters = 0

    def wave(o, d, active):
        nonlocal tests, iters
        res = _check(t, scene, o, d, active)
        live = int(active.view(-1, 32).any(1).sum())
        tests += int(res.tests.sum()) + live * t.n_groups
        iters += live

    rk.wave_rays(*_headline_rays([150, 650], 2, rr), sm, _cam(), wave,
                 samples=2, max_depth=25, rr_start=rr)
    assert iters > 0 and tests / iters / sm.shape[0] < 0.5


def _grazing(t, sm, origin_scale):
    """Rays tangent to a group's outermost member at its point farthest
    from the bound's centre, nudged by 0, +-1 ulp-scale and +-1e-6 across
    the tangent, from origins at ``origin_scale`` from the tangent point;
    and each ray's grazed slot."""
    c, r = sm[:, 0:3].double(), sm[:, rk.COL_RADIUS].double().abs()
    gen = torch.Generator().manual_seed(7)
    os_, ds, aims = [], [], []
    for g in range(t.n_groups):
        ks = [k for k in t.slot[t.n_large + g * gs.GROUP:
                               t.n_large + (g + 1) * gs.GROUP].tolist()
              if k >= 0]
        b = t.bound[g, :3].double()
        reach = (c[ks] - b).norm(dim=1) + r[ks]
        k = ks[int(reach.argmax())]
        u = c[k] - b
        u = u / u.norm().clamp_min(1e-12)
        p = c[k] + r[k] * u
        for _ in range(4):
            v = torch.randn(3, generator=gen, dtype=torch.float64)
            v = v - (v @ u) * u
            v = v / v.norm()
            for nudge in (0.0, 2e-7, -2e-7, 1e-6, -1e-6):
                q = p + nudge * u
                os_.append(q - origin_scale * v)
                aims.append(k)
                ds.append(v * float(torch.rand(1, generator=gen) * 2 + 0.1))
    o = torch.stack(os_).float()
    d = torch.stack(ds).float()
    pad = -len(os_) % 32
    o = torch.cat([o, o[:pad]])
    d = torch.cat([d, d[:pad]])
    aims = torch.tensor(aims + aims[:pad])
    return (Vec3(o[:, 0], o[:, 1], o[:, 2]), Vec3(d[:, 0], d[:, 1], d[:, 2]),
            aims)


@pytest.mark.parametrize("name", ["cover", "random2000"])
@pytest.mark.parametrize("origin_scale", [3.0, 300.0])
def test_model_on_grazing_rays(name, origin_scale):
    """Rays that graze a member sphere at the edge of its group's bound,
    near and far: the scan's winner is hit_world's, and some of them hit
    that member."""
    scene = SCENES[name]("cpu")
    sm, t = _table(name)
    o, d, aims = _grazing(t, sm, origin_scale)
    res = _check(t, scene, o, d)
    on = res.hit & (res.idx == aims)
    assert bool(on.any()) and not bool(on.all())


def test_model_on_far_and_degenerate_rays():
    """Rays whose magnitudes leave the rounding argument (|d|^2 below
    1e-12 or above kSafe, |o|^2 above kSafe) open every group, and rays
    from far away: the winner is hit_world's."""
    scene = build_scene(1, device="cpu")
    sm, t = _table("cover")
    gen = torch.Generator().manual_seed(11)
    n = 256
    target = (torch.rand((n, 3), generator=gen) - 0.5) * torch.tensor(
        [22.0, 1.0, 22.0])
    scale = torch.tensor([1e-7, 1e-3, 1.0, 1e7] * (n // 4))[:, None]
    far = torch.tensor([1.0, 1e3, 1e6, 1e3] * (n // 4))[:, None]
    dirn = torch.randn((n, 3), generator=gen)
    dirn = dirn / dirn.norm(dim=1, keepdim=True)
    o = target - far * dirn
    d = dirn * scale
    o, d = Vec3(*o.float().unbind(1)), Vec3(*d.float().unbind(1))
    res = _check(t, scene, o, d)
    assert bool(res.hit.any())
    assert int(res.opened.max()) == t.n_groups  # wide lanes open every group


def test_duplicate_spheres_in_two_groups_lower_slot_wins():
    """Two copies of one sphere in two groups, the higher slot's group
    walked first: every ray at it (from above, where nothing hides it) ties
    exactly, and the lower slot wins, as in the brute-force scan."""
    scene, lo, hi = tie_scene("cpu")
    sm = rk.pack_scene_matrix(scene)
    t = gs.unpack(gs.group_table_reference(sm, _cam()), sm.shape[0])
    grp = groups_of(t)
    assert grp[hi] < grp[lo]
    c = sm[lo, 0:3]
    rad = float(sm[lo, rk.COL_RADIUS])
    gen = torch.Generator().manual_seed(3)
    aim = c + (torch.rand((128, 3), generator=gen) - 0.5) * rad
    o = (c + torch.tensor([0.0, 3.0, 0.0])).expand(128, 3)
    d = aim - o
    res = _check(t, scene, Vec3(*o.unbind(1)), Vec3(*d.unbind(1)))
    hit_dup = res.hit & ((res.idx == lo) | (res.idx == hi))
    assert int(hit_dup.sum()) > 32
    assert bool((res.idx[hit_dup] == lo).all())


@pytest.mark.parametrize("name,slots,two_level", [
    ("deep", 8, False), ("cover", 512, True)])
def test_scene_too_small_for_groups_scans_in_one_level(name, slots,
                                                       two_level):
    """A scene of fewer than 2 x GROUP slots takes the one-level scan: no
    table (and no launch), its count mode's plain version opens nothing and
    tests every slot; the twin refuses it."""
    scene = (build_deep_scene(device="cpu") if name == "deep"
             else build_scene(1, device="cpu"))
    sm = rk.pack_scene_matrix(scene)
    assert sm.shape[0] == slots
    assert gs.uses_groups(slots, "vmem") == two_level
    if two_level:
        return
    soa = sm[:, :rk.USED_COLS].t().contiguous()
    before = dict(trace.counts())
    assert gs.group_table(soa, _cam(16, 8), "vmem") is None
    gs.count_path(None)
    after = trace.counts()
    assert after.get("launch.group_table", 0) == before.get(
        "launch.group_table", 0)
    assert after["scan.one_level"] == before.get("scan.one_level", 0) + 1
    with pytest.raises(ValueError, match="group table"):
        gs.group_table_reference(sm, _cam())
    inputs = rk.regen_inputs(scene, CameraConfig.reference_default(), 16, 8, 2)
    seg, issues, opened, tests = rk.regen_counts_reference(
        *inputs, samples=2, max_depth=6)
    assert bool((opened == 0).all())
    assert torch.equal(tests, issues * slots)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES) + ["moved"])
def test_table_equals_twin_on_card(cuda, name):
    """The card's table is its twin's word for word: scene 1, scene 2, 2000
    random spheres, the tie scene, and scene 1 with its centres and radii
    moved as a train step would move them."""
    scene = SCENES["cover" if name == "moved" else name](cuda)
    sm = rk.pack_scene_matrix(scene)
    if name == "moved":
        gen = torch.Generator().manual_seed(1)
        sm[:, 0:4] += (torch.randn(sm[:, 0:4].shape, generator=gen) * 0.05).to(cuda)
    cam = _cam(64, 40).to(cuda)
    before = trace.counts().get("launch.group_table", 0)
    got = gs.group_table_kernel(sm[:, :rk.USED_COLS].t().contiguous(), cam)
    torch.cuda.synchronize()
    assert trace.counts().get("launch.group_table", 0) == before + 1
    assert torch.equal(got.cpu(), gs.group_table_reference(sm, cam).cpu())


@pytest.mark.cuda
def test_launches_count_their_scan_on_card(cuda):
    """Kernel 1 over scene 1 builds a table and scans in two levels; over
    the 8-slot deep scene, and in layout 'hbm', in one."""
    cam = CameraConfig.reference_default()
    for scene, layout, two in ((build_scene(1, device=cuda), "vmem", True),
                               (build_scene(1, device=cuda), "hbm", False),
                               (build_deep_scene(device=cuda), "vmem", False)):
        inputs = rk.regen_inputs(scene, cam, 32, 20, 2)
        before = dict(trace.counts())
        rk.regen_kernel(*inputs, samples=2, max_depth=6, layout=layout)
        torch.cuda.synchronize()
        after = trace.counts()
        rise = {k: after.get(k, 0) - before.get(k, 0)
                for k in ("launch.group_table", "scan.two_level",
                          "scan.one_level")}
        assert rise == {"launch.group_table": int(two),
                        "scan.two_level": int(two),
                        "scan.one_level": int(not two)}, (layout, rise)
