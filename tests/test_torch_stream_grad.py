"""Stream gradients (ops/stream_train_kernel.py): the plain versions, the
record scatter, and the kernel on the card.

On the CPU ``render_stream_grads`` runs the plain version: the stream
walk as the hit test, the reverse of ``train_kernel``, and the records
summed by ``segment_sum_reference``. The tests hold it to the JAX oracle
run op by op (1e-4 of each leaf's largest entry), to the JAX stream
gradient kernel in interpret mode (XLA compiles it and fuses
multiply-adds, so a few knife-edge paths go elsewhere: a share-of-entries
bound), to the port's brute-force plain gradients (1e-5: summation order
only), and the scatter to its association written out as loops (bit for
bit). The ``cuda`` tests hold the kernel to its plain
version on the card and skip without one; JAX is imported inside the
tests that use it, so that ``pytest --noconftest -m cuda`` runs this file
on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.camera import initialize
from raytracingincuda_torch.models.scene import build_random_scene
from raytracingincuda_torch.ops import kernel_io as kio
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import stream_kernel as sk
from raytracingincuda_torch.ops import stream_train_kernel as stk
from raytracingincuda_torch.ops import train_kernel as tk
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


def _close(got, want, frac, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


@pytest.fixture(scope="module")
def spread():
    """90 spheres (seed 7) over a 16 x 16 patch in blocks of 32: the
    Morton sort moves spheres across blocks, so a wrong row mapping shows
    as swapped gradient rows. (JAX scene, port scene)."""
    import jax

    from raytracingincuda_torch.models.convert import scene_from_numpy
    from raytracingincuda_tpu.models.scene import build_random_scene as jbrs

    js = jbrs(90, seed=7, pad_to_multiple=32, half_extent=8.0)
    return js, scene_from_numpy([np.asarray(x) for x in
                                 jax.tree_util.tree_leaves(js)], device="cpu")


@pytest.fixture(scope="module")
def weight():
    return np.random.default_rng(0).standard_normal((H, W, 3)).astype(
        np.float32) / SPP


def test_stream_grads_match_pallas_stream_grads(spread, weight):
    """The plain gradients vs ``render_pallas_stream_grads`` in interpret
    mode, both in stream row order. XLA's fused multiply-adds send a few
    knife-edge paths elsewhere (measured: 6 of 2048 entries of d_stream
    beyond 1e-3 of its largest entry, at most 3.2e-3; the camera row, a
    sum over all pixels, at most 4.7e-3), so: every entry within 1e-2 of
    the largest, and at least 99% of d_stream's within 1e-3."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.ops.pallas_stream import prepare_stream_scene
    from raytracingincuda_tpu.ops.pallas_stream_backward import (
        render_pallas_stream_grads)

    js, ts = spread
    want = render_pallas_stream_grads(
        prepare_stream_scene(js, block=32), JCam.reference_default(),
        jnp.asarray(weight), W, H, SPP, DEPTH, ray_tile=128, interpret=True)
    got = stk.render_stream_grads(sk.prepare_stream_scene(ts, block=32),
                                  TCam.reference_default(),
                                  torch.from_numpy(weight), W, H, SPP, DEPTH)
    for g, w, share in zip(got, want, (0.99, 0.0)):
        g, w = g.numpy(), np.asarray(w)
        err = np.abs(g - w) / np.abs(w).max()
        assert np.isfinite(g).all()
        assert (err <= 1e-3).mean() >= share and err.max() <= 1e-2, (
            (err <= 1e-3).mean(), err.max())
    assert not got[0][:, kio.GRAD_COLS:].any()


def test_stream_grads_match_eager_jax_oracle(spread, weight):
    """Chained to the parameters, the plain stream gradients vs jax.vjp
    through the JAX oracle's raw radiance sum run op by op, where the
    arithmetic is the port's but for its rsqrt estimate: 1e-4 of each
    leaf's largest entry (of all 12 for the camera's scalars; measured
    5.1e-6 at worst)."""
    import jax
    import jax.numpy as jnp

    from raytracingincuda_torch.models.camera import config_leaves
    from raytracingincuda_torch.models.scene import param_leaves
    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.models.scene import Scene as JScene
    from raytracingincuda_tpu.ops import tracer as jtr

    js, ts = spread

    def render(p, c):
        return jtr.render(JScene(p, js.mat_type, js.active), c, W, H, SPP,
                          DEPTH, accumulate_only=True)

    with jax.disable_jit():
        _, vjp = jax.vjp(render, js.params, JCam.reference_default())
        jp, jc = vjp(jnp.asarray(weight))
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(ts, block=32)
    d_stream, d_cam = stk.render_stream_grads(st, cam, torch.from_numpy(weight),
                                              W, H, SPP, DEPTH)
    tp, tc = tk.chain_to_params(
        stk.stream_grads_to_scene_mat(d_stream, st, ts.num_slots), d_cam,
        ts.params, cam, ts.mat_type, ts.active, W, H)
    for k, (a, b) in enumerate(zip(param_leaves(tp),
                                   jax.tree_util.tree_leaves(jp))):
        _close(a, b, 1e-4, f"param leaf {k}")
    jc = np.array([float(x) for x in jax.tree_util.tree_leaves(jc)])
    _close(torch.stack(config_leaves(tc)), jc, 1e-4, "camera")


@pytest.mark.parametrize("rr", [None, 2])
def test_stream_grads_equal_brute_force(spread, weight, rr):
    """Mapped to scene order, the stream gradients are the brute-force
    plain gradients (layout 'hbm') up to summation order (1e-5 of the
    largest entry), with the walk in Morton and front-to-back order."""
    _, ts = spread
    cam = TCam.reference_default()
    g = torch.from_numpy(weight)
    want = tk.render_kernel_grads(ts, cam, g, W, H, SPP, DEPTH, rr_start=rr,
                                  layout="hbm")
    for kw in (dict(), dict(camdist_from=initialize(cam, W, H).center)):
        st = sk.prepare_stream_scene(ts, block=32, **kw)
        d_stream, d_cam = stk.render_stream_grads(st, cam, g, W, H, SPP,
                                                  DEPTH, rr_start=rr)
        d_sm = stk.stream_grads_to_scene_mat(d_stream, st, ts.num_slots)
        _close(d_sm, want[0].numpy(), 1e-5, "d_scene_mat")
        _close(d_cam, want[1].numpy(), 1e-5, "d_cam_row")


def test_stream_grads_to_scene_mat_matches_jax(spread):
    import jax.numpy as jnp

    from raytracingincuda_tpu.ops.pallas_stream import prepare_stream_scene
    from raytracingincuda_tpu.ops.pallas_stream_backward import (
        stream_grads_to_scene_mat)

    js, ts = spread
    jst = prepare_stream_scene(js, block=32)
    st = sk.prepare_stream_scene(ts, block=32)
    d = np.random.default_rng(1).standard_normal(
        (st.scene_mat.shape[0], 16)).astype(np.float32)
    want = stream_grads_to_scene_mat(jnp.asarray(d), jst, js.num_slots)
    got = stk.stream_grads_to_scene_mat(torch.from_numpy(d), st, ts.num_slots)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scan(f, v):
    """One warp's segmented inclusive scan, lane by lane: in steps of 1, 2,
    4, 8 and 16 lanes, lane l without a head takes lane l - step's value
    on the left."""
    for step in (1, 2, 4, 8, 16):
        f0, v0 = list(f), list(v)
        for lane in range(step, 32):
            if not f0[lane]:
                v[lane] = v0[lane - step] + v0[lane]
            f[lane] = f0[lane] or f0[lane - step]


def _sequential_segment_sum(keys, src, vals, n_rows):
    """The scatter's association written out as loops: per tile of
    ``stk.TILE`` sorted records, a segmented scan in each warp of 32, then
    over the warps' totals, each record adding the total of the warps
    before it on the left; a run inside a tile is its last record's sum; a
    run across tile edges adds its tile sums lane by lane over 32 lanes,
    then in a halving tree."""
    keys, src, vals = keys.tolist(), src.tolist(), vals.numpy()
    m, tile = len(keys), stk.TILE
    out = np.zeros((n_rows, 9), np.float32)
    head, tail = {}, {}
    for t in range(-(-m // tile)):
        base = t * tile
        f = [base + u < m and (u == 0 or keys[base + u - 1] != keys[base + u])
             for u in range(tile)]
        v = [vals[src[base + u]] if base + u < m else np.zeros(9, np.float32)
             for u in range(tile)]
        warps = [(f[w:w + 32], v[w:w + 32]) for w in range(0, tile, 32)]
        for fw, vw in warps:
            _scan(fw, vw)
        tot_f, tot_v = [fw[-1] for fw, _ in warps], [vw[-1] for _, vw in warps]
        _scan(tot_f, tot_v)
        for w, (fw, vw) in enumerate(warps):
            for lane in range(32):
                u, q = w * 32 + lane, base + w * 32 + lane
                if w and not fw[lane]:
                    vw[lane] = tot_v[w - 1] + vw[lane]
                if q >= m or not (u == tile - 1 or q + 1 >= m
                                  or keys[q + 1] != keys[q]):
                    continue
                before = base > 0 and keys[base] == keys[base - 1] == keys[q]
                after = u == tile - 1 and q + 1 < m and keys[q + 1] == keys[q]
                if after:
                    tail[t] = vw[lane]
                if before:
                    head[t] = vw[lane]
                if not (before or after):
                    out[keys[q]] = vw[lane]
    for t, part in tail.items():        # runs leaving the tile they start in
        key = keys[t * tile + tile - 1]
        if t and keys[t * tile - 1] == key:
            continue
        last = max(q for q in range(m) if keys[q] == key) // tile
        lanes = [np.zeros(9, np.float32) for _ in range(32)]
        for i, p in enumerate([part] + [head[u] for u in range(t + 1, last + 1)]):
            lanes[i % 32] = lanes[i % 32] + p
        off = 16
        while off:
            for lane in range(off):
                lanes[lane] = lanes[lane] + lanes[lane + off]
            off //= 2
        out[key] = lanes[0]
    return out


def test_record_scatter_order():
    """``record_order`` keeps each row's records in record order;
    ``segment_sum_reference`` adds them in the kernels' association, bit
    for bit, with a row across two tiles; the sums agree with index_add_
    to 1e-5."""
    rng = np.random.default_rng(2)
    rows = rng.integers(-1, 40, 3000).astype(np.int32)
    rows[100:1400] = 5                      # one row across two tiles
    vals = torch.from_numpy(rng.standard_normal((3000, 9)).astype(np.float32))
    keys, src = stk.record_order(torch.from_numpy(rows))
    assert keys.dtype == torch.int32 and src.dtype == torch.int64
    assert (np.diff(keys.numpy()) >= 0).all()
    for k in (5, 17):
        assert (np.diff(src.numpy()[keys.numpy() == k]) > 0).all()
    got = stk.segment_sum_reference(keys, src, vals, 40)
    np.testing.assert_array_equal(got.numpy(), _sequential_segment_sum(
        keys, src, vals, 40))
    want = torch.zeros((40, 9)).index_add_(0, keys.long(), vals[src])
    _close(got, want.numpy(), 1e-5, "segment sums")
    assert not stk.scatter_records(torch.full((10,), -1, dtype=torch.int32),
                                   torch.zeros((10, 9)), 4).any()


def _case_rows(case, rng):
    """(record rows, n_rows) of one scatter case."""
    if case == "row_across_many_tiles":
        rows = rng.integers(-1, 50, 12_000)
        rows[500:9000] = 7                  # 8500 records of row 7
        return rows, 50
    if case == "runs_crossing_tile_edges":
        return rng.integers(0, 12, 5000), 12   # runs of ~400 records
    if case == "single_record_rows":
        return rng.permutation(3000), 3000
    if case == "all_minus_one":
        return np.full(500, -1), 8
    return np.zeros(0, np.int64), 8        # empty


@pytest.mark.parametrize("case", [
    "row_across_many_tiles", "runs_crossing_tile_edges",
    "single_record_rows", "all_minus_one", "empty"])
def test_segment_sum_cases(case):
    """The plain segmented sum equals the loops above bit for bit and a
    float64 index_add_ within 1e-5 of the largest entry."""
    rng = np.random.default_rng(4)
    rows, n_rows = _case_rows(case, rng)
    vals = torch.from_numpy(rng.standard_normal((rows.shape[0], 9)).astype(
        np.float32))
    keys, src = stk.record_order(torch.from_numpy(rows.astype(np.int32)))
    got = stk.segment_sum_reference(keys, src, vals, n_rows)
    assert got.shape == (n_rows, 9) and got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), _sequential_segment_sum(keys, src, vals, n_rows))
    want = torch.zeros((n_rows, 9), dtype=torch.float64).index_add_(
        0, keys.long(), vals[src].double()).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-6))
    if case in ("all_minus_one", "empty"):
        assert not got.any()


def test_stream_gradient_arguments_raise(spread):
    _, ts = spread
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(ts, block=32)
    ids, ii, jj, _, _, row = rk.regen_inputs(ts, cam, W, H, SPP)
    rows = torch.zeros((3, ids.shape[0]))
    args = (ids, ii, jj, rows, st.scene_mat, st.bounds, row)
    with pytest.raises(ValueError, match="CUDA"):
        stk.stream_grads_kernel(*args, block=32, samples=SPP, max_depth=DEPTH)
    with pytest.raises(ValueError, match="CUDA"):
        stk.fused_stream_kernel(*args, block=32, samples=SPP, max_depth=DEPTH,
                                num_pixels=W * H)
    # the sampler's bound, with its message (JAX's validate_stream_ids);
    # 65 bounces run, and no record count raises any more
    with pytest.raises(ValueError, match="bounce counter field"):
        stk.stream_grads_reference(*args, block=32, samples=1,
                                   max_depth=tk.MAX_DEPTH + 1)
    stk.stream_grads_reference(*args, block=32, samples=1,
                               max_depth=tk.STACK_SHALLOW + 1)
    assert len(stk.plan_records(ids.shape[0], 1 << 20, 256)) == -(-(1 << 20)
                                                                 // 546)
    with pytest.raises(ValueError, match="CUDA"):
        stk.walk_counts(ids, ii, jj, st.scene_mat, st.bounds, row, block=32,
                        samples=SPP, max_depth=DEPTH)
    with pytest.raises(ValueError, match="CUDA"):
        stk.segment_sum_kernel(torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int64),
                               torch.zeros((1, 9)), 1)


@pytest.mark.parametrize("budget,n_windows", [
    (2 * rk.PAD * DEPTH * stk.RECORD_BYTES, 4),   # chunks of 256 lanes
    (W * H * DEPTH * stk.RECORD_BYTES, 2),        # one sample a window
])
def test_stream_grads_in_record_windows(spread, weight, budget, n_windows):
    """The plain gradient mode in the windows of a small record budget
    (sample windows, and chunks of lanes where a sample does not fit)
    equals one window within 1e-6 of each output's largest entry: the
    windows' sums add in another order."""
    _, ts = spread
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(ts, block=32)
    ids, ii, jj, _, _, row = rk.regen_inputs(ts, cam, W, H, SPP)
    g = kio.lane_rows(torch.from_numpy(weight), ids, W * H)
    args = (ids, ii, jj, g, st.scene_mat, st.bounds, row)
    kw = dict(block=32, samples=SPP, max_depth=DEPTH, rr_start=2)
    assert len(stk.plan_records(ids.shape[0], SPP, DEPTH, budget)) == n_windows
    one = stk.stream_grads_reference(*args, **kw)
    got = stk.stream_grads_reference(*args, budget=budget, **kw)
    for a, b, what in zip(got, one, ("d_stream", "d_cam_row")):
        _close(a, b.numpy(), 1e-6, what)


@pytest.mark.cuda
@pytest.mark.parametrize("rr", [None, 2])
def test_stream_grads_kernel_equals_plain_version_on_card(cuda, rr):
    """The gradient mode vs its plain version on the card: 1e-4 of the
    largest entry (the hand adjoint's rounding), the same bits from run to
    run."""
    s = build_random_scene(1000, seed=3, device=cuda)
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(s, block=64)
    ids, ii, jj, _, _, row = rk.regen_inputs(s, cam, 64, 40, 2)
    g = (torch.randn((3, ids.shape[0]), generator=torch.Generator()
                     .manual_seed(0)) * 1e-3).to(cuda)
    args = (ids, ii, jj, g, st.scene_mat, st.bounds, row)
    kw = dict(block=64, samples=2, max_depth=6, rr_start=rr)
    before = trace.counts().get("launch.stream_train", 0)
    got = stk.stream_grads_kernel(*args, **kw)
    again = stk.stream_grads_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert trace.counts().get("launch.stream_train", 0) == before + 2
    want = stk.stream_grads_reference(*args, **kw)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        _close(a, c.cpu().numpy(), 1e-4, "stream gradients")


@pytest.mark.cuda
def test_segment_sum_kernel_equals_plain_version_on_card(cuda):
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.integers(-1, 500, 100_000).astype(np.int32))
    rows[:30_000] = 7                      # one row across 30 tiles
    vals = torch.from_numpy(rng.standard_normal((100_000, 9)).astype(
        np.float32))
    keys, src = stk.record_order(rows)
    before = trace.counts().get("launch.stream_segment_sum", 0)
    got = stk.segment_sum_kernel(keys.to(cuda), src.to(cuda), vals.to(cuda),
                                 500)
    # its two kernels
    assert trace.counts().get("launch.stream_segment_sum", 0) == before + 2
    assert torch.equal(got.cpu(), stk.segment_sum_reference(keys, src, vals,
                                                            500))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_stream_train_kernel_blocks_of_1024_rr2_on_card(cuda, fused):
    """Kernel 5 with blocks of 1024 rows (staged in pieces) and rr_start=2
    against its plain version on the card: the fused image bit for bit
    (and the stream kernel's), the gradients within 1e-4 of the largest
    entry and the same bits from run to run."""
    s = build_random_scene(3000, seed=5, device=cuda)
    cam = TCam.reference_default()
    st = sk.reorder_front_to_back(sk.prepare_stream_scene(s, block=1024),
                                  initialize(cam, 64, 40).center)
    ids, ii, jj, bud, _, row = rk.regen_inputs(s, cam, 64, 40, 2)
    rows = torch.rand((3, ids.shape[0]), generator=torch.Generator()
                      .manual_seed(2)).to(cuda)
    args = (ids, ii, jj, rows if fused else rows * 1e-3, st.scene_mat,
            st.bounds, row)
    kw = dict(block=1024, samples=2, max_depth=6, rr_start=2)
    if fused:
        kw.update(num_pixels=64 * 40, loss="mse", gamma=False)
        kernel, plain = stk.fused_stream_kernel, stk.fused_stream_reference
    else:
        kernel, plain = stk.stream_grads_kernel, stk.stream_grads_reference
    got, again = kernel(*args, **kw), kernel(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if fused:
        assert torch.equal(got[1], want[1])
        img4 = sk.stream_kernel(ids, ii, jj, bud, st.scene_mat, st.bounds,
                                row, block=1024, samples=2, max_depth=6,
                                rr_start=2)
        assert torch.equal(got[1], img4 * tk.loss_constants(
            2, 64 * 40, 1.0)["inv_spp"])
        got, want = (got[0].reshape(1), got[2], got[3]), (
            want[0].reshape(1), want[2], want[3])
    for a, c in zip(got, want):
        _close(a, c.cpu().numpy(), 1e-4, "stream gradients")


@pytest.mark.cuda
@pytest.mark.parametrize("rr", [None, 2])
def test_stream_grads_kernel_in_record_windows_on_card(cuda, rr):
    """The gradient mode in forced windows (chunks of lanes and samples)
    against its plain version in the same windows: 1e-4 of the largest
    entry, the same bits from run to run, one launch a window."""
    s = build_random_scene(1000, seed=3, device=cuda)
    cam = TCam.reference_default()
    st = sk.prepare_stream_scene(s, block=64)
    ids, ii, jj, _, _, row = rk.regen_inputs(s, cam, 64, 40, 4)
    g = torch.randn((3, ids.shape[0]), generator=torch.Generator().manual_seed(
        4)).to(cuda)
    budget = 7 * rk.PAD * 6 * stk.RECORD_BYTES   # 20 blocks a sample: 3 chunks
    kw = dict(block=64, samples=4, max_depth=6, rr_start=rr, budget=budget)
    args = (ids, ii, jj, g, st.scene_mat, st.bounds, row)
    n = len(stk.plan_records(ids.shape[0], 4, 6, budget))
    before = trace.counts().get("launch.stream_train", 0)
    got = stk.stream_grads_kernel(*args, **kw)
    again = stk.stream_grads_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert n == 12
    assert trace.counts().get("launch.stream_train", 0) == before + 2 * n
    want = stk.stream_grads_reference(*args, **kw)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        _close(a, c.cpu().numpy(), 1e-4, "windowed gradient mode")
