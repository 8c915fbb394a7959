"""The stream walk's second level: groups of rows inside each block.

Kernels 4 and 5 test a block's rows only in the groups whose conservative
box some lane can improve in (``csrc/staged_walk.cuh``). On the CPU, the
plain twin (``stream_kernel.Walk`` with ``walk_groups_reference``'s
table) is held to the one-level walk on adversarial cases: every ray whose
root lies in a group passes that group's box at that root, and the grouped
walk returns the one-level walk's (hit, t, winner). The ``cuda`` tests hold
the card's table to its twin word for word and the walk's work counts to
the twin's; they skip without a card. No JAX here, so ``pytest
--noconftest -m cuda`` runs this file on a machine without it.
"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig, initialize
from raytracingincuda_torch.models.scene import build_random_scene
from raytracingincuda_torch.ops import kernel_io as kio
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import stream_kernel as sk
from raytracingincuda_torch.ops import stream_train_kernel as stk
from raytracingincuda_torch.ops.intersect import T_MISS, root_numerators
from raytracingincuda_torch.ops.vec import Vec3
from raytracingincuda_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

LANES = 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def stream_of(c, r, block, sort=True):
    """A prepared stream of spheres at centres ``c`` (N, 3) with radii
    ``r`` (N,), all lambertian and active."""
    m = torch.zeros((len(r), rk.NUM_COLS), dtype=torch.float32)
    m[:, 0:3] = torch.as_tensor(np.asarray(c), dtype=torch.float32)
    m[:, 3] = torch.as_tensor(np.asarray(r), dtype=torch.float32)
    m[:, 4:7] = 0.5
    m[:, rk.COL_ACTIVE] = 1.0
    return sk.prepare_stream_scene(kio.scene_from_matrix(m), block=block,
                                   sort=sort)


def flat(n, extent, rng):
    """``random_spheres``' layout: radii 0.15-0.35 resting on y = 0 over a
    +-extent patch, and the ground sphere first."""
    r = rng.uniform(0.15, 0.35, n)
    c = np.stack([rng.uniform(-extent, extent, n), r,
                  rng.uniform(-extent, extent, n)], 1)
    return (np.concatenate([[[0.0, -1000.0, 0.0]], c]),
            np.concatenate([[1000.0], r]))


def unit(v):
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def scattered(c, r, n, rng):
    """Rays leaving random spheres' surfaces in random directions (random
    lengths), and rays from a camera-like point at random spheres."""
    k = rng.integers(0, len(r), n)
    o1 = c[k] + np.abs(r[k])[:, None] * unit(rng.normal(size=(n, 3)))
    d1 = unit(rng.normal(size=(n, 3))) * rng.uniform(0.5, 2.0, (n, 1))
    eye = np.array([13.0, 2.0, 3.0]) * np.abs(c).max() / 50.0
    o2 = np.repeat(eye[None], n, 0)
    d2 = c[rng.integers(0, len(r), n)] + rng.normal(size=(n, 3)) - eye
    return np.concatenate([o1, o2]), np.concatenate([d1, d2])


def grazing(c, r, n, rng, back=(1.0, 100.0),
            eps=(-1e-6, -1e-7, 0.0, 1e-7, 1e-6)):
    """Rays tangent to random spheres from ``back`` units before the
    tangent point, their distance from the centre |r| (1 + eps), eps drawn
    from ``eps``."""
    k = rng.integers(1, len(r), n)
    d = unit(rng.normal(size=(n, 3)))
    side = unit(np.cross(d, rng.normal(size=(n, 3))))
    e = rng.choice(eps, n)
    o = (c[k] + (np.abs(r[k]) * (1.0 + e))[:, None] * side
         - rng.uniform(*back, (n, 1)) * d)
    return o, d


def aimed(c, origins, n, rng, length):
    """Rays from ``origins`` (n, 3) at random sphere centres, |d| = length
    (n,)."""
    d = unit(c[rng.integers(0, len(c), n)] + rng.normal(size=(n, 3)) * 0.1
             - origins)
    return origins, d * length[:, None]


def case(name):
    """(stream, ray origins (R, 3), directions (R, 3)) of one case."""
    rng = np.random.default_rng(CASES.index(name))
    block = {"block_64": 64, "block_1024": 1024, "padding": 64}.get(name, 256)
    extent = 500.0 if name in ("spread_500", "grazing_far") else 50.0
    c, r = flat(2999, extent, rng)
    sort = True
    if name == "hollow":                 # glass shells: r and -0.9 r
        c, r = np.concatenate([c, c[1:]]), np.concatenate([r, -0.9 * r[1:]])
    if name == "padding":                # 70 spheres: the tail groups empty
        c, r = c[:70], r[:70]
    if name == "outside_safe":           # spheres beyond kSafe
        far = rng.normal(size=(8, 3))
        c = np.concatenate([c, 1.2e6 * unit(far)])
        r = np.concatenate([r, np.full(8, 0.3)])
    if name == "ties":                   # exact twins in one group, across
        c, r = c[:600], r[:600]          # groups and across blocks
        for a, b in ((3, 4), (5, 40), (10, 300), (20, 21), (33, 511)):
            c[b], r[b] = c[a], r[a]
        sort = False
    st = stream_of(c, r, block, sort)
    n = LANES // 2
    if name == "grazing":
        o, d = grazing(c, r, 2 * n, rng)
    elif name == "grazing_far":          # S' about 1e4: the slot test's
        o, d = grazing(c, r, 2 * n, rng, back=(3e3, 1e4), eps=(  # reach is
            -1e-3, 0.0, 1e-3, 1e-2, 0.1, 1.0, 3.0, 10.0))        # units wide
    elif name == "tiny_d":               # |d|^2 about the 1e-12 clamp
        o = c[rng.integers(1, len(r), 2 * n)] + np.array([0.0, 3.0, 0.0])
        o, d = aimed(c, o, 2 * n, rng, np.sqrt(rng.choice(
            [0.5e-12, 0.99e-12, 1e-12, 1.01e-12, 2e-12, 1e-10], 2 * n)))
    elif name == "far_o":                # |o|^2 about kSafe
        o = unit(rng.normal(size=(2 * n, 3))) * np.sqrt(sk.SAFE * rng.choice(
            [0.98, 0.999, 1.0, 1.001, 1.02], (2 * n, 1)))
        o, d = aimed(c, o, 2 * n, rng, rng.uniform(0.5, 2.0, 2 * n))
    elif name == "ties":                 # through the twins
        tw = np.array([3, 5, 10, 20, 33])[rng.integers(0, 5, 2 * n)]
        o = c[tw] + np.array([0.0, 5.0, 0.0]) + rng.normal(size=(2 * n, 3))
        d = c[tw] + rng.normal(size=(2 * n, 3)) * 0.05 - o
    else:
        o, d = scattered(c, r, n, rng)
    return st, o.astype(np.float32), d.astype(np.float32)


def vec3(a):
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return Vec3(t[:, 0].contiguous(), t[:, 1].contiguous(),
                t[:, 2].contiguous())


CASES = ["spread_50", "spread_500", "block_64", "block_1024", "grazing",
         "grazing_far", "tiny_d", "far_o", "hollow", "padding",
         "outside_safe", "ties"]


def test_box_pad_covers_the_slot_test_reach():
    """The box's widening exceeds the slot test's reach, sqrt(40 u) per unit
    of S, plus 64 u of the box's and the box test's own rounding (the header
    of ``staged_walk.cuh``, items 3-5), and is the value the header's
    arithmetic states."""
    u = 2.0 ** -24
    assert sk.BOX_PAD > math.sqrt(40 * u) + 64 * u
    src = (Path(sk.__file__).parent.parent / "csrc"
           / "staged_walk.cuh").read_text()
    stated = src.split("kBoxPad = ", 1)[1].split()[0]
    assert float.fromhex(stated) == sk.BOX_PAD


@pytest.mark.parametrize("name", CASES)
def test_group_cull_keeps_every_root(name):
    """Every (ray, group) that holds a root Z of the ray passes the group's
    box at cap Z, and at the cap a block's t_cur gives where that root would
    still win (the smallest t_cur above Z (1/a), times a); so the grouped
    walk returns the one-level walk's hit, t and winner, lane for lane."""
    st, o_np, d_np = case(name)
    o, d = vec3(o_np), vec3(d_np)
    table = sk.walk_groups_reference(st.scene_mat, st.block)
    per = sk.block_groups(st.block)
    t_num, a = root_numerators(kio.scene_from_matrix(st.scene_mat), o, d)
    a = a[0]
    ray = sk._box_ray(o, d)
    ng = table.shape[0]
    rows = ng * sk.GROUP
    k = torch.arange(rows)
    b, g = k // (per * sk.GROUP), k % (per * sk.GROUP) // sk.GROUP
    start = (k % (per * sk.GROUP)) % sk.GROUP + g * sk.GROUP
    inside = start < st.block
    z = torch.full((rows, t_num.shape[1]), T_MISS)
    z[inside] = t_num[(b * st.block + start)[inside]]
    zmin = z.view(ng, sk.GROUP, -1).amin(1)
    t_b = zmin * (1.0 / a)
    t_cur = torch.nextafter(t_b, torch.full_like(t_b, math.inf))
    cap = torch.minimum(zmin, t_cur * a)
    held = zmin < T_MISS
    for q in range(ng):
        if bool(held[q].any()):
            ok = sk._box_can_improve(table[q], ray, cap[q])
            assert bool(ok[held[q]].all()), (name, q)
    if name == "padding":
        assert bool((table[-3:, 4:7] == -math.inf).all())
    if name == "outside_safe":
        assert bool((table[:, 4:7] == math.inf).any())

    active = torch.ones(o.x.shape[0], dtype=torch.bool)
    want = sk.Walk(st.scene_mat, st.bounds, st.block)(o, d, active)
    walk = sk.Walk(st.scene_mat, st.bounds, st.block, groups=table)
    walk.count(o.x.shape[0], "cpu")
    got = walk(o, d, active)
    assert torch.equal(got.hit, want.hit)
    assert torch.equal(got.t, want.t)
    assert torch.equal(got.idx, want.idx)
    assert bool(want.hit.any())
    if name in ("spread_50", "spread_500", "block_64", "block_1024"):
        assert int(walk.tested.sum()) < int(walk.fetched.sum()) * st.block // 2


def test_group_table_reference_layout():
    """Groups of GROUP rows in matrix order inside each block, the last
    one shorter where GROUP does not divide the block; each box holds its
    active rows' centres within E less their largest |r|."""
    rng = np.random.default_rng(4)
    c, r = flat(200, 10.0, rng)
    r[5] = -r[5]                                  # hollow glass: |r|
    st = stream_of(c, r, 40)
    table = sk.walk_groups_reference(st.scene_mat, 40)
    assert sk.block_groups(40) == 3
    assert table.shape == (st.scene_mat.shape[0] // 40 * 3, 8)
    m = st.scene_mat
    for q in range(table.shape[0]):
        b, g = divmod(q, 3)
        lo, hi = b * 40 + 16 * g, min(b * 40 + 16 * g + 16, (b + 1) * 40)
        rows = m[lo:hi][m[lo:hi, rk.COL_ACTIVE] > 0.5]
        if rows.shape[0] == 0:
            assert bool((table[q, 4:7] == -math.inf).all())
            continue
        reach = (rows[:, 0:3] - table[q, 0:3]).abs() + rows[:, 3:4].abs()
        assert bool((reach <= table[q, 4:7]).all()), q


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed,block", [(100_000, 3, 256),
                                          (1_000_000, 7, 1024)])
def test_group_table_on_card_equals_twin(cuda, n, seed, block):
    """The walk's tables built on the card (the launch before every walk)
    equal their plain versions word for word: the scan table and the group
    table, at the 100k (blocks of 256) and 1M (blocks of 1024) scenes."""
    s = build_random_scene(n, seed=seed, device=cuda)
    st = sk.prepare_stream_scene(s)
    assert st.block == block
    launches = trace.counts().get("launch.walk_tables", 0)
    scan, groups = sk.walk_tables_kernel(st.scene_mat, block)
    torch.cuda.synchronize()
    assert trace.counts()["launch.walk_tables"] == launches + 1
    want = sk.walk_groups_reference(st.scene_mat, block)
    assert torch.equal(groups.cpu().view(torch.int32),
                       want.cpu().view(torch.int32))
    m = st.scene_mat.cpu()
    c2r2 = ((m[:, 0] * m[:, 0] + m[:, 1] * m[:, 1]) + m[:, 2] * m[:, 2]
            - m[:, 3] * m[:, 3])
    live = m[:, rk.COL_ACTIVE] > 0.5
    got = scan.cpu()
    assert torch.equal(got[:, 0:3], m[:, 0:3])
    assert torch.equal(got[live, 3], c2r2[live])
    assert bool(got[~live, 3].isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 256, 1024])
def test_walk_counts_on_card(cuda, block):
    """Kernel 4's four count rows equal the grouped plain twin's; kernel
    5's walk opens the same blocks a lane, and its warps test no more rows
    than their blocks hold. Each walk launch counts its table launch
    (``launch.walk_tables``) and its group rows (``stream.groups``)."""
    s = build_random_scene(20_000, seed=3, device=cuda)
    cam = CameraConfig.reference_default()
    st = sk.reorder_front_to_back(sk.prepare_stream_scene(s, block=block),
                                  initialize(cam, 64, 40).center)
    ids, ii, jj, bud, _, row = rk.regen_inputs(s, cam, 64, 40, 2)
    kw = dict(block=block, samples=2, max_depth=6, rr_start=None)
    args = (ids, ii, jj, bud, st.scene_mat, st.bounds, row)
    before = trace.counts().get("stream.groups", 0)
    tables = trace.counts().get("launch.walk_tables", 0)
    got = sk.stream_kernel(*args, emit_stats=True, **kw)
    torch.cuda.synchronize()
    assert trace.counts()["stream.groups"] == (
        before + st.bounds.shape[0] * sk.block_groups(block))
    assert trace.counts()["launch.walk_tables"] == tables + 1
    want = sk.stream_reference(*args, emit_stats=True, **kw)
    assert torch.equal(got, want)
    assert 0 < float(got[3].sum()) < float(got[2].sum()) * block
    opened, fetched, tested = stk.walk_counts(
        ids, ii, jj, st.scene_mat, st.bounds, row, block=block, samples=2,
        max_depth=6)
    assert trace.counts()["launch.walk_tables"] == tables + 2
    assert int(opened.long().sum()) == int(got[1].sum())
    assert bool((tested <= fetched * block).all())
    assert int(tested.long().sum()) > 0
