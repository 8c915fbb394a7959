"""Streamed scenes (ops/stream_kernel.py): preparation, the plain walk,
the renderer, and the stream kernel on the card.

Preparation is numpy in both packages, so its arrays equal the JAX ones
bit for bit. The plain walk equals the port's own brute-force plain
render (``regen_reference``, layout 'hbm') bit for bit, since a stream
image differs from it only at exact ties between blocks; against the JAX
stream kernel in interpret mode, which XLA compiles, images pass the
cross-framework gate of ``utils/ppm.py``. The ``cuda`` tests hold the
kernel to its plain version on the card and skip without one; JAX is
imported inside the tests that use it, so that ``pytest --noconftest -m
cuda`` runs this file on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.camera import initialize
from raytracingincuda_torch.models.scene import build_random_scene, build_scene
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import stream_kernel as sk
from raytracingincuda_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

W, H, SPP, DEPTH = 24, 16, 2, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def _both(jscene):
    """(JAX scene, port scene) from one JAX scene's leaves."""
    import jax

    from raytracingincuda_torch.models.convert import scene_from_numpy

    return jscene, scene_from_numpy([np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(jscene)],
                                    device="cpu")


def _jax_scene(kind):
    from raytracingincuda_tpu.models.scene import build_random_scene as jbrs
    from raytracingincuda_tpu.models.scene import build_scene as jbs

    if kind == "scene1":
        return jbs(1)
    return jbrs(1000, pad_to_multiple=128)


@pytest.mark.parametrize("kind, kw", [
    ("scene1", dict(block=32)),
    ("random", dict(block=128)),
    ("random", dict(block=128, sort=False)),
    ("random", dict(block=64, camdist_from=(13.0, 2.0, 3.0))),
    ("random", dict(block=256, pad_pairs=False)),
])
def test_prepare_matches_jax(kind, kw):
    """Columns 0-15, bounds, perm and block equal the JAX package's."""
    from raytracingincuda_tpu.ops.pallas_stream import prepare_stream_scene

    from raytracingincuda_torch.models.convert import stream_scene_from_numpy

    js, ts = _both(_jax_scene(kind))
    want = prepare_stream_scene(js, **kw)
    got = sk.prepare_stream_scene(ts, **kw)
    carried = stream_scene_from_numpy(want.scene_mat, want.bounds,
                                      want.block, want.perm, device="cpu")
    for st in (got, carried):
        assert st.block == want.block
        np.testing.assert_array_equal(st.scene_mat.numpy(),
                                      np.asarray(want.scene_mat)[:, :16])
        np.testing.assert_array_equal(st.bounds.numpy(),
                                      np.asarray(want.bounds))
        np.testing.assert_array_equal(st.perm.numpy(), np.asarray(want.perm))
        assert st.perm.dtype == torch.int32


def test_auto_block_matches_jax():
    from raytracingincuda_tpu.ops.pallas_stream import _auto_block

    for n in (1, 4096, 458_751, 458_752, 1_000_000, 5_000_000):
        for block in (64, 256):
            assert sk._auto_block(n, block) == _auto_block(n, block)
    # the 1M-sphere scale cell: 978 blocks of 1024
    assert sk._auto_block(1_000_000, 256) == 1024


def test_build_stream_arrays_matches_jax():
    """The matrix exactly; the bounds within 1e-6 relative (another
    summation order and sqrt); a border reorders the bounds rows."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.ops.pallas_stream import (build_stream_arrays,
                                                        prepare_stream_scene)

    js, ts = _both(_jax_scene("random"))
    st = sk.prepare_stream_scene(ts, block=128)
    border = np.random.default_rng(0).permutation(st.n_blocks).astype(np.int32)
    want_m, want_b = build_stream_arrays(
        js, prepare_stream_scene(js, block=128).perm, 128,
        st.scene_mat.shape[0], border=jnp.asarray(border))
    got_m, got_b = sk.build_stream_arrays(ts, st.perm, 128,
                                          st.scene_mat.shape[0],
                                          border=torch.from_numpy(border))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m)[:, :16])
    np.testing.assert_array_equal(got_m.numpy(), st.scene_mat.numpy())
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(got_b.numpy(), st.bounds.numpy()[border],
                               rtol=1e-6, atol=0)


def test_front_to_back_border_matches_jax():
    """The frozen visit order for training, from Morton and from
    camera-ordered bounds rows alike."""
    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.ops.grad import front_to_back_border
    from raytracingincuda_tpu.ops.pallas_stream import prepare_stream_scene

    from raytracingincuda_torch.ops import grad as tgrad

    js, ts = _both(_jax_scene("random"))
    for kw in (dict(), dict(camdist_from=(13.0, 2.0, 3.0))):
        want = front_to_back_border(prepare_stream_scene(js, block=64, **kw),
                                    JCam.reference_default(), W, H)
        got = tgrad.front_to_back_border(
            sk.prepare_stream_scene(ts, block=64, **kw),
            TCam.reference_default(), W, H)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def small():
    """300 spheres over a 20 x 20 patch in blocks of 64 (six blocks)."""
    from raytracingincuda_tpu.models.scene import build_random_scene as jbrs

    return _both(jbrs(300, pad_to_multiple=128, half_extent=10.0))


def test_stream_reference_matches_jax_interpret(small):
    """The plain walk vs the JAX stream kernel in interpret mode at 24x16,
    2 spp, 4 bounces: the cross-framework gate."""
    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.ops.pallas_stream import (prepare_stream_scene,
                                                        render_pallas_stream)
    from raytracingincuda_torch.utils import ppm

    js, ts = small
    want = render_pallas_stream(prepare_stream_scene(js, block=64),
                                JCam.reference_default(), W, H, SPP, DEPTH,
                                ray_tile=128, interpret=True)
    got = sk.render_stream(sk.prepare_stream_scene(ts, block=64),
                           TCam.reference_default(), W, H, SPP, DEPTH)
    stats = ppm.diff_stats(got.numpy(), ppm.quantize(np.asarray(want)))
    assert ppm.passes_cross_framework_gate(stats), stats


@pytest.mark.parametrize("rr", [None, 2])
def test_stream_reference_equals_brute_force(small, rr):
    """Morton and front-to-back walks both equal the all-slot plain
    render (layout 'hbm') bit for bit."""
    _, ts = small
    cam = TCam.reference_default()
    inputs = rk.regen_inputs(ts, cam, W, H, SPP)
    want = rk.regen_reference(*inputs, samples=SPP, max_depth=DEPTH,
                              rr_start=rr, layout="hbm")
    ids, ii, jj, bud, _, row = inputs
    for kw in (dict(), dict(camdist_from=initialize(cam, W, H).center)):
        st = sk.prepare_stream_scene(ts, block=64, **kw)
        got = sk.stream_reference(ids, ii, jj, bud, st.scene_mat, st.bounds,
                                  row, block=64, samples=SPP,
                                  max_depth=DEPTH, rr_start=rr)
        assert torch.equal(got, want)


def test_render_stream_contract(small):
    """Sample windows add up (to 1e-6: the sums associate differently),
    a pixel order changes nothing, budgets cap each pixel, and the work
    counts hold the traced segments and the opened blocks."""
    _, ts = small
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(ts, block=64)
    full = sk.render_stream(st, cam, W, H, 4, 3, accumulate_only=True)
    a = sk.render_stream(st, cam, W, H, 2, 3, accumulate_only=True)
    b = sk.render_stream(st, cam, W, H, 2, 3, accumulate_only=True,
                         sample_offset=2)
    torch.testing.assert_close(a + b, full, rtol=1e-6, atol=0)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(W * H))
    assert torch.equal(sk.render_stream(st, cam, W, H, 4, 3, pixel_order=perm),
                       sk.render_stream(st, cam, W, H, 4, 3))
    budgets = torch.from_numpy(np.random.default_rng(2).integers(0, 5, W * H))
    capped = sk.render_stream(st, cam, W, H, 4, 3, sample_budgets=budgets,
                              accumulate_only=True)
    assert torch.equal(capped.reshape(-1, 3)[budgets == 0], torch.zeros(
        (int((budgets == 0).sum()), 3)))
    assert torch.equal(capped.reshape(-1, 3)[budgets == 4],
                       full.reshape(-1, 3)[budgets == 4])
    ids, ii, jj, bud, _, row = rk.regen_inputs(ts, cam, W, H, SPP)
    stats = sk.stream_reference(ids, ii, jj, bud, st.scene_mat, st.bounds,
                                row, block=64, samples=SPP, max_depth=DEPTH,
                                emit_stats=True)
    seg = rk.regen_reference(ids, ii, jj, bud, st.scene_mat, row,
                             samples=SPP, max_depth=DEPTH, emit_depth=True,
                             layout="hbm")
    assert torch.equal(stats[0], seg[0])
    assert 0 < float(stats[1].sum()) < float(stats[0].sum()) * st.n_blocks


@pytest.mark.parametrize("rr", [None, 2])
def test_plain_warp_union_between_max_and_sum_of_opened(small, rr):
    """The plain walk's warp-union count, with per-pixel budgets: each warp
    walks at least the blocks of its busiest lane and at most the sum of
    its lanes' opened blocks, and tests at most the rows those blocks hold;
    both counts sit at each warp's first lane, and the lanes' segments are
    the brute-force plain render's."""
    _, ts = small
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(ts, block=64,
                                 camdist_from=initialize(cam, W, H).center)
    nb = torch.from_numpy(np.random.default_rng(6).integers(0, 4, W * H))
    ids, ii, jj, bud, _, row = rk.regen_inputs(ts, cam, W, H, 3,
                                               sample_budgets=nb)
    kw = dict(samples=3, max_depth=DEPTH, rr_start=rr)
    stats = sk.stream_reference(ids, ii, jj, bud, st.scene_mat, st.bounds,
                                row, block=64, emit_stats=True, **kw)
    assert stats.shape == (4, ids.shape[0])
    seg = rk.regen_reference(ids, ii, jj, bud, st.scene_mat, row,
                             emit_depth=True, layout="hbm", **kw)
    assert torch.equal(stats[0], seg[0])
    opened = stats[1].view(-1, 32)
    fetched = stats[2].view(-1, 32)
    assert not bool(fetched[:, 1:].any())
    assert bool((fetched[:, 0] >= opened.amax(1)).all())
    assert bool((fetched[:, 0] <= opened.sum(1)).all())
    assert bool((fetched[:, 0] < opened.sum(1)).any())
    tested = stats[3].view(-1, 32)
    assert not bool(tested[:, 1:].any())
    assert bool((tested[:, 0] <= fetched[:, 0] * 64).all())
    assert 0 < float(tested.sum()) < float(fetched.sum()) * 64


def test_stream_arguments_raise(small):
    _, ts = small
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(ts, block=64)
    ids, ii, jj, bud, _, row = rk.regen_inputs(ts, cam, W, H, SPP)
    args = (ids, ii, jj, bud, st.scene_mat, st.bounds, row)
    with pytest.raises(ValueError, match="CUDA"):
        sk.stream_kernel(*args, block=64, samples=SPP, max_depth=DEPTH)
    with pytest.raises(ValueError, match="blocks"):
        sk.stream_reference(*args, block=100, samples=SPP, max_depth=DEPTH)
    with pytest.raises(ValueError, match="bounds"):
        sk.stream_reference(*args[:5], st.bounds[:, :4].contiguous(), row,
                            block=64, samples=SPP, max_depth=DEPTH)
    shifted = st.bounds.clone()
    shifted[0, 4] += 1.0                # a first row off the block grid
    with pytest.raises(ValueError, match="first matrix row"):
        sk.stream_reference(*args[:5], shifted, row, block=64, samples=SPP,
                            max_depth=DEPTH)
    with pytest.raises(TypeError, match="Mesh"):
        sk.render_stream(st, cam, W, H, SPP, DEPTH, mesh=object())
    with pytest.raises(NotImplementedError):
        sk.prepare_stream_scene(ts, dtype=torch.float64)


ENTRIES = ("render_stream", "mse_train_stream", "render_stream_grads")


def _enter(entry, st, cam):
    """One call of a stream entry point on ``st`` at the file's shape."""
    from raytracingincuda_torch.ops import stream_train_kernel as stk

    img = torch.zeros((H, W, 3), device=st.scene_mat.device)
    if entry == "render_stream":
        return sk.render_stream(st, cam, W, H, SPP, DEPTH)
    if entry == "mse_train_stream":
        return stk.mse_train_stream(st, cam, img, W, H, SPP, DEPTH)
    return stk.render_stream_grads(st, cam, img, W, H, SPP, DEPTH)


def _host_syncs(fn) -> int:
    before = trace.counts().get("host_sync", 0)
    fn()
    return trace.counts().get("host_sync", 0) - before


def _outside_bounds_checked(entry, ts, device):
    """The port's own bounds (prepared, reordered front to back, rebuilt
    in ``front_to_back_border``'s order or in any other) pass the walk's
    check with no host wait; bounds from outside are read on the host, and a bad column
    4 raises there, as it does in a table of the port's written in place."""
    from raytracingincuda_torch.models.scene import Scene
    from raytracingincuda_torch.ops import grad as tgrad

    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(ts, block=64)
    front = sk.reorder_front_to_back(st, initialize(cam, W, H).center)
    scene = Scene(ts.params, ts.mat_type, ts.active)
    rows = st.scene_mat.shape[0]
    step = sk.StreamScene(*sk.build_stream_arrays(
        scene, st.perm, 64, rows,
        border=tgrad.front_to_back_border(st, cam, W, H)), 64, st.perm)
    canonical = sk.StreamScene(*sk.build_stream_arrays(
        scene, st.perm, 64, rows, border=torch.arange(
            st.n_blocks, dtype=torch.int32, device=device)), 64, st.perm)
    for own in (st, front, step, canonical):
        assert _host_syncs(lambda: _enter(entry, own, cam)) == 0
    outside = st._replace(bounds=st.bounds.clone())
    assert _host_syncs(lambda: _enter(entry, outside, cam)) > 0
    bad = outside.bounds.clone()
    bad[0, 4] += 1.0                    # a first row off the block grid
    with pytest.raises(ValueError, match="first matrix row"):
        _enter(entry, st._replace(bounds=bad), cam)
    st.bounds[0, 4] += 1.0              # the same, in the port's own table
    with pytest.raises(ValueError, match="first matrix row"):
        _enter(entry, st, cam)


@pytest.mark.parametrize("entry", ENTRIES)
def test_outside_bounds_checked_at_every_entry(small, entry):
    _outside_bounds_checked(entry, small[1], torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_outside_bounds_checked_at_every_entry_on_card(cuda, entry):
    """As on the CPU, through the kernels."""
    _outside_bounds_checked(entry, build_random_scene(
        300, seed=3, half_extent=10.0, device=cuda), cuda)


def test_front_to_back_border_refuses_a_bad_column(small):
    """The border of a fit indexes each block once, or raises before any
    step: a bounds table whose column 4 names a block twice, or that lacks
    a block."""
    from raytracingincuda_torch.ops import grad as tgrad

    _, ts = small
    st = sk.prepare_stream_scene(ts, block=64)
    cam = TCam.reference_default()
    border = tgrad.front_to_back_border(st, cam, W, H)
    assert sorted(border.tolist()) == list(range(st.n_blocks))
    twice = st.bounds.clone()
    twice[1, 4] = twice[0, 4]
    for bad in (twice, st.bounds[1:]):
        with pytest.raises(ValueError, match="each of the"):
            tgrad.front_to_back_border(st._replace(bounds=bad), cam, W, H)


@pytest.mark.cuda
@pytest.mark.parametrize("rr", [None, 2])
def test_stream_kernel_equals_plain_version_on_card(cuda, rr):
    """The kernel vs its plain version on the card: bit for bit, the same
    bits from run to run, and the same work counts."""
    s = build_random_scene(2000, seed=3, device=cuda)
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(s, camdist_from=initialize(cam, 64, 40).center)
    ids, ii, jj, bud, _, row = rk.regen_inputs(s, cam, 64, 40, 2)
    args = (ids, ii, jj, bud, st.scene_mat, st.bounds, row)
    kw = dict(block=st.block, samples=2, max_depth=6, rr_start=rr,
              finalize_scale=0.5)
    before = trace.counts().get("launch.stream_render", 0)
    got = sk.stream_kernel(*args, **kw)
    again = sk.stream_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert trace.counts().get("launch.stream_render", 0) == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, sk.stream_reference(*args, **kw))
    counts = sk.stream_kernel(*args, emit_stats=True, **kw)
    assert torch.equal(counts, sk.stream_reference(*args, emit_stats=True,
                                                   **kw))


@pytest.mark.cuda
def test_packed_scene_one_block_on_card(cuda):
    """Scene 1 as one block (the 'packed' route) equals the regen kernel's
    'hbm' image bit for bit."""
    s = build_scene(1, device=cuda)
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(s, block=512, pad_pairs=False)
    assert st.n_blocks == 1
    got = sk.render_stream(st, cam, 64, 40, 4, 8, rr_start=2)
    want = rk.render_kernel(s, cam, 64, 40, 4, 8, rr_start=2, layout="hbm")
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [256, 1024])
@pytest.mark.parametrize("rr", [None, 2])
def test_stream_kernel_equals_plain_and_kernel5_on_card(cuda, block, rr):
    """Kernel 4's regenerating loop with the staged walk: its image equals
    the plain version's and kernel 5's fused image bit for bit, in Morton
    and front-to-back order, and its work counts (segments, opened blocks,
    each warp's union) equal the plain walk's."""
    from raytracingincuda_torch.ops import stream_train_kernel as stk

    s = build_random_scene(20_000, seed=3, device=cuda)
    cam = TCam.reference_default()
    morton = sk.prepare_stream_scene(s, block=block)
    front = sk.reorder_front_to_back(morton, initialize(cam, 64, 40).center)
    assert morton.block == block
    ids, ii, jj, bud, _, row = rk.regen_inputs(s, cam, 64, 40, 2)
    tgt = torch.rand((3, ids.shape[0]), generator=torch.Generator()
                     .manual_seed(7)).to(cuda)
    for st in (morton, front):
        args = (ids, ii, jj, bud, st.scene_mat, st.bounds, row)
        kw = dict(block=block, samples=2, max_depth=6, rr_start=rr)
        got = sk.stream_kernel(*args, finalize_scale=0.5, **kw)
        assert torch.equal(got, sk.stream_reference(*args, finalize_scale=0.5,
                                                    **kw))
        _, img5, _, _ = stk.fused_stream_kernel(
            ids, ii, jj, tgt, st.scene_mat, st.bounds, row,
            num_pixels=64 * 40, gamma=True, **kw)
        assert torch.equal(got, img5)
        assert torch.equal(sk.stream_kernel(*args, emit_stats=True, **kw),
                           sk.stream_reference(*args, emit_stats=True, **kw))
