"""Stream gradients (ops/stream_train_kernel.py): the plain versions, the
record scatter, and the kernel on the card.

On the CPU ``render_stream_grads`` runs the plain version: the stream
walk as the hit test, the reverse of ``train_kernel``, and the records
summed by ``segment_sum_reference``. The tests hold it to the JAX oracle
run op by op (1e-4 of each leaf's largest entry), to the JAX stream
gradient kernel in interpret mode (XLA compiles it and fuses
multiply-adds, so a few knife-edge paths go elsewhere: a share-of-entries
bound), to the port's brute-force plain gradients (1e-5: summation order
only), and the scatter to a sequential sum in the same order (bit for
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
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import stream_kernel as sk
from raytracingincuda_torch.ops import stream_train_kernel as stk
from raytracingincuda_torch.ops import train_kernel as tk

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
                                 jax.tree_util.tree_leaves(js)])


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
    assert not got[0][:, tk.GRAD_COLS:].any()


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


def _sequential_segment_sum(keys, src, vals, n_rows):
    """The scatter's order written out as loops: per chunk, runs summed in
    position order; per row, its run sums in chunk order."""
    keys, src, vals = keys.tolist(), src.tolist(), vals.numpy()
    m, chunk = len(keys), stk.CHUNK
    part = {}
    for c0 in range(0, m, chunk):
        start, v = c0, vals[src[c0]].copy()
        for q in range(c0 + 1, min(c0 + chunk, m)):
            if keys[q] != keys[start]:
                part[start], start, v = v, q, vals[src[q]].copy()
            else:
                v = (v + vals[src[q]]).astype(np.float32)
        part[start] = v
    out = np.zeros((n_rows, 9), np.float32)
    for q in range(m):
        if q and keys[q - 1] == keys[q]:
            continue
        v, r = part[q].copy(), (q // chunk + 1) * chunk
        while r < m and keys[r] == keys[q]:
            v = (v + part[r]).astype(np.float32)
            r += chunk
        out[keys[q]] = v
    return out


def test_record_scatter_order():
    """``record_order`` keeps each row's records in record order;
    ``segment_sum_reference`` adds them in the kernel's order, bit for bit,
    with rows spanning many chunks; the sums agree with index_add_ to
    1e-5."""
    rng = np.random.default_rng(2)
    rows = rng.integers(-1, 40, 3000).astype(np.int32)
    rows[100:1400] = 5                      # one row across six chunks
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
    with pytest.raises(ValueError, match="stack"):
        stk.stream_grads_reference(*args, block=32, samples=1,
                                   max_depth=tk.MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="records"):
        stk._check(*args, block=32, samples=1 << 20, max_depth=64,
                   rr_start=None, sample_offset=0)
    with pytest.raises(ValueError, match="CUDA"):
        stk.segment_sum_kernel(torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int64),
                               torch.zeros((1, 9)), 1)


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
    before = stk.LAUNCHES
    got = stk.stream_grads_kernel(*args, **kw)
    again = stk.stream_grads_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert stk.LAUNCHES == before + 2
    want = stk.stream_grads_reference(*args, **kw)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        _close(a, c.cpu().numpy(), 1e-4, "stream gradients")


@pytest.mark.cuda
def test_segment_sum_kernel_equals_plain_version_on_card(cuda):
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.integers(-1, 500, 100_000).astype(np.int32))
    rows[:30_000] = 7
    vals = torch.from_numpy(rng.standard_normal((100_000, 9)).astype(
        np.float32))
    keys, src = stk.record_order(rows)
    before = stk.SEGMENT_LAUNCHES
    got = stk.segment_sum_kernel(keys.to(cuda), src.to(cuda), vals.to(cuda),
                                 500)
    assert stk.SEGMENT_LAUNCHES == before + 2      # its two kernels
    assert torch.equal(got.cpu(), stk.segment_sum_reference(keys, src, vals,
                                                            500))
