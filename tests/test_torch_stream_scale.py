"""Streamed scenes at the million-sphere configuration's block size.

A scene of 1,000,001 active rows takes blocks of 1024 rows
(``_auto_block``), so the walk stages each block in four pieces. On the
CPU: the block rule, the fused train step on a stream prepared in blocks
of 1024 against the benchmark's plain reference gradient
(``portbench/reference``: every sphere tested, autograd through the
winner), and the counters and span of the stream step. The ``cuda`` tests
hold kernel 5 (and the stream render, which walks with it) to their plain
versions on the million-sphere scene itself, on a slice of the lanes of
its train cell's shape; they skip without a card. No JAX here, so
``pytest --noconftest -m cuda`` runs this file on a machine without it.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import port
from portbench.reference import scenes, tracer
from raytracingincuda_torch.models.camera import CameraConfig, initialize
from raytracingincuda_torch.models.scene import build_random_scene
from raytracingincuda_torch.ops import grad
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import stream_kernel as sk
from raytracingincuda_torch.ops import stream_train_kernel as stk
from raytracingincuda_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

W, H, SPP, DEPTH, SEED = 8, 6, 1, 6, 1227
CAMERA = json.loads((Path(port.__file__).parent / "configs" / "random_1m.json"
                     ).read_text())["camera"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def test_auto_block_at_a_million_spheres():
    """1,000,001 active rows in pairs of blocks: 256 and 512 give more than
    the 1792-block cap, 1024 gives 978 blocks of 1,001,472 rows; the
    configuration's scene (seed 7, ±50) prepared on the CPU (about 1 s)."""
    assert sk._auto_block(1_000_001, 256) == 1024
    assert sk._auto_block(1_000_001, 1024) == 1024
    assert sk._auto_block(100_001, 256) == 256
    st = sk.prepare_stream_scene(build_random_scene(
        1_000_000, seed=7, half_extent=50.0, device="cpu"))
    assert (st.block, st.n_blocks, st.scene_mat.shape[0]) == (1024, 978,
                                                               1_001_472)
    assert st.perm.shape[0] == 1_000_001


@pytest.fixture(scope="module")
def stepped():
    """3,000 spheres over a ±6 patch (the reference camera sees many), in
    blocks of 1024 front to back; one fused MSE step from the scene as
    drawn, traced: (arrays, stream, loss, gradient per leaf, records,
    counts)."""
    arrays = scenes.random_spheres(3000, seed=7, half_extent=6.0)
    scene = port.scene({**{k: torch.tensor(arrays[k], dtype=torch.float32)
                           for k in tracer.LEAVES},
                        "mat": torch.from_numpy(arrays["mat"]),
                        "active": torch.from_numpy(arrays["active"])})
    stream = sk.prepare_stream_scene(scene, block=1024)
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(5))
    init_fn, step_fn = grad.make_stream_train(stream, W, H, SPP, DEPTH,
                                              seed=SEED, fused=True)
    cam = port.camera(CAMERA)
    state = init_fn(scene.params)
    trace.reset()
    with trace.recording():
        new, loss = step_fn(state, cam, scene.mat_type, scene.active, target)
    g = [m / (1.0 - 0.9) for m in port.leaves(new.opt_state.mu)]
    return arrays, stream, float(loss), g, trace.records(), trace.counts()


def test_fused_step_in_blocks_of_1024_against_the_plain_reference(stepped):
    """The step's loss and every leaf's gradient (read from Adam's first
    moment) against the reference's MSE through autograd, in float32 on
    every pixel: the loss to 1e-5, each leaf to 1e-4 of its largest
    entry (the sums run in another order). Every leaf but ``ior`` has a
    gradient here; ``ior``'s is zero on both sides."""
    arrays, stream, loss, got, _, _ = stepped
    assert (stream.block, stream.n_blocks) == (1024, 4)
    sc = tracer.scene_tensors(arrays, "cpu", requires_grad=True)
    cam = tracer.camera(CAMERA, W, H, "cpu")
    acc, _ = tracer.radiance(sc, cam, SEED, torch.arange(W * H), W, SPP,
                             DEPTH)
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(5))
    want = ((acc * (1.0 / SPP) - target.view(-1, 3).t()) ** 2).mean()
    grads = torch.autograd.grad(want, [sc[k] for k in tracer.LEAVES])
    np.testing.assert_allclose(loss, float(want.detach()), rtol=1e-5)
    live = torch.from_numpy(arrays["active"])
    for k, a, b in zip(tracer.LEAVES, got, grads):
        a, b = a[live].double().numpy(), b[live].double().numpy()
        assert np.abs(b).max() > 0 or k == "ior", k
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=k)


def test_stream_step_counters_and_span(stepped):
    """A stream step counts its rebuild's matrix rows (``stream.rows``)
    and maps its cotangents to slots under ``rt.stream.to_slots``, a child
    of the step; the plain walk launches nothing, so ``stream.blocks``,
    ``stream.groups`` and ``launch.walk_tables`` stay out."""
    _, stream, _, _, recs, counts = stepped
    assert counts["stream.rows"] == stream.scene_mat.shape[0] == 4096
    assert "stream.blocks" not in counts and "stream.groups" not in counts
    assert "launch.walk_tables" not in counts
    root = [r for r in recs if r.name == "rt.stream_step"]
    slots = [r for r in recs if r.name == "rt.stream.to_slots"]
    assert len(root) == len(slots) == 1
    assert recs[slots[0].parent] is root[0]
    assert "rt.records" not in {r.name for r in recs}
    assert root[0].counts["stream.rows"] == 4096


@pytest.mark.cuda
def test_stream_blocks_counter_on_card(cuda):
    """Each walk launch of kernels 4 and 5 adds its bounds rows to
    ``stream.blocks`` and their blocks' group rows to ``stream.groups``:
    one stream render, then one fused step."""
    s = build_random_scene(1000, seed=3, device=cuda)
    cam = CameraConfig.reference_default()
    st = sk.prepare_stream_scene(s, block=64)
    nb, ng = st.bounds.shape[0], st.bounds.shape[0] * sk.block_groups(64)
    before = trace.counts().get("stream.blocks", 0)
    groups = trace.counts().get("stream.groups", 0)
    sk.render_stream(st, cam, 64, 40, 2, 4)
    assert trace.counts()["stream.blocks"] == before + nb
    assert trace.counts()["stream.groups"] == groups + ng
    init_fn, step_fn = grad.make_stream_train(st, 64, 40, 2, 4)
    step_fn(init_fn(s.params), cam, s.mat_type, s.active,
            torch.rand((40, 64, 3), device=cuda))
    torch.cuda.synchronize()
    assert trace.counts()["stream.blocks"] == before + 2 * nb
    assert trace.counts()["stream.groups"] == groups + 2 * ng


@pytest.mark.cuda
def test_kernel5_in_blocks_of_1024_on_the_million_sphere_scene(cuda):
    """The million-sphere configuration's scene (seed 7, ±50) prepared as
    its cell prepares it (blocks of 1024, 978 of them, front to back),
    at the train cell's shape (640x384, 1 spp, 6 bounces, MSE, linear) on
    image rows 184-191 (5120 lanes): kernel 5's fused mode against its
    plain version, the image bit-equal (and to the stream render's sums:
    1 spp, linear),
    the loss to 1e-6, the gradients to 1e-4 of the largest entry. A block
    takes four pieces, each staged while the one before is tested."""
    s = build_random_scene(1_000_000, seed=7, half_extent=50.0, device=cuda)
    cam = CameraConfig.reference_default()
    st = sk.prepare_stream_scene(s)
    assert (st.block, st.n_blocks) == (1024, 978)
    st = sk.reorder_front_to_back(st, initialize(cam, 640, 384).center)
    ids, ii, jj, bud, _, row = rk.regen_inputs(s, cam, 640, 384, 1)
    sl = slice(184 * 640, 192 * 640)
    ids, ii, jj, bud = (t[sl].contiguous() for t in (ids, ii, jj, bud))
    tgt = torch.rand((3, ids.shape[0]), generator=torch.Generator()
                     .manual_seed(1)).to(cuda)
    args = (ids, ii, jj, tgt, st.scene_mat, st.bounds, row)
    kw = dict(block=1024, samples=1, max_depth=6, rr_start=None,
              num_pixels=640 * 384, gamma=False, loss="mse")
    got = stk.fused_stream_kernel(*args, **kw)
    torch.cuda.synchronize()
    want = stk.fused_stream_reference(*args, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[1], sk.stream_kernel(
        ids, ii, jj, bud, st.scene_mat, st.bounds, row, block=1024,
        samples=1, max_depth=6))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    for a, b, what in zip(got[2:], want[2:], ("d_stream", "d_cam_row")):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert np.isfinite(a).all(), what
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-6),
                                   err_msg=what)
