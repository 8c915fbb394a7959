"""Multiple devices over torch.distributed (``parallel/mesh.py``) on the CPU.

The counterpart of ``tests/test_sharding.py``. One ``torchrun`` launch of
two gloo ranks (``parallel/worker.py``) runs every sharded path on scene 2
at the JAX tests' shape (64x32, 2 spp, 4 bounces); the same jobs run in
this process on one rank (``worker.run_job`` without a process group) as
the single-process reference. On the CPU the kernel paths run the
kernels' plain versions; ``chip_smoke.py`` phase 22 runs the kernels.

Held: every forward path (the oracle, kernel 1's route, kernel 7, kernel
4, adaptive sampling, the f64 oracle, a 2-D (dp, sp) mesh of 2x1) gives
the single-process bits on both ranks; the gradient paths (the oracle in
f32 and f64, kernel 3, kernel 2's fused step, the three train steps,
kernel 5's fused and two-program stream steps) give the loss within rtol
1e-6 and the gradients or parameters within rtol 1e-4 / atol 1e-7 (JAX's
``test_sharding.py`` bounds), the same bits on both ranks and from run to
run; a fused step makes one ``all_reduce``. The child processes run torch
on one thread (torchrun's default) and the launch has its own timeout.
"""
import json
import os

import numpy as np
import pytest
import torch

from raytracingincuda_torch.config import RenderConfig
from raytracingincuda_torch.parallel import mesh as meshlib
from raytracingincuda_torch.parallel import worker
from raytracingincuda_torch.render_api import make_renderer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, DEPTH = 64, 32, 2, 4
STREAM = dict(n_spheres=600, half_extent=10.0, stream_block=64, samples=1)
JOBS = [
    dict(job="render", impl="oracle", tag="oracle"),
    dict(job="render", impl="kernel", tag="kernel"),
    dict(job="kernel", mode="compact", tag="compact"),
    dict(job="kernel", axes=["dp", "sp"], tag="mesh2d"),
    dict(job="stream", tag="stream", **STREAM),
    dict(job="adaptive", samples=4, max_samples=16, adaptive_tol=0.1,
         tag="adaptive"),
    dict(job="adaptive", samples=4, max_samples=16, adaptive_tol=0.1,
         rounds=2, n_spheres=600, half_extent=10.0, stream_block=64,
         tag="adaptive_stream"),
    dict(job="render", impl="oracle", dtype="float64", tag="oracle_f64"),
    dict(job="grads", impl="oracle", tag="grads_oracle"),
    dict(job="grads", impl="oracle", dtype="float64", tag="grads_oracle_f64"),
    dict(job="grads", impl="kernel", rr_start=1, tag="grads_kernel"),
    dict(job="fused", rr_start=1, tag="fused"),
    dict(job="train", impl="fused", tag="train_fused"),
    dict(job="train", impl="kernel", tag="train_kernel"),
    dict(job="train", impl="oracle", tag="train_oracle"),
    dict(job="stream_train", tag="stream_train", **STREAM),
    dict(job="stream_train", fused=False, tag="stream_train_2p", **STREAM),
]
DEFAULTS = dict(scene_id=2, width=W, height=H, samples=SPP, bounces=DEPTH,
                rr_start=None, impl="kernel")
FORWARD = ("oracle", "kernel", "compact", "mesh2d", "stream", "adaptive",
           "adaptive_stream", "oracle_f64")
GRADIENT = ("grads_oracle", "grads_oracle_f64", "grads_kernel", "fused",
            "train_fused", "train_kernel", "train_oracle", "stream_train",
            "stream_train_2p")


def _load(d, tag, rank):
    with np.load(os.path.join(d, f"{tag}_r{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(sharded dir, the ranks' status, single-process dir)."""
    two = str(tmp_path_factory.mktemp("two_ranks"))
    one = str(tmp_path_factory.mktemp("one_rank"))
    jobs = os.path.join(two, "jobs.json")
    with open(jobs, "w") as f:
        json.dump(JOBS, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = worker.torchrun(
        ["-m", "raytracingincuda_torch.parallel.worker", "--device", "cpu",
         "--outdir", two, "--jobs", jobs, "--width", str(W), "--height",
         str(H)], timeout=300, env=env, cwd=two)
    assert res.returncode == 0, res.stderr[-4000:]
    status = json.loads(res.stdout.strip().splitlines()[-1])["ranks"]
    for job in JOBS:
        worker.run_job(job, DEFAULTS, "cpu", one)
    return two, status, one


def _rec(status, rank, tag):
    return next(j for j in status[rank]["jobs"] if j["tag"] == tag)


def test_two_ranks_launched(runs):
    _, status, _ = runs
    assert [s["rank"] for s in status] == [0, 1]
    assert all(s["world"] == 2 and s["backend"] == "gloo" for s in status)
    assert _rec(status, 0, "mesh2d")["mesh_shape"] == [2, 1]


@pytest.mark.parametrize("tag", FORWARD)
def test_sharded_forward_equals_single_process(runs, tag):
    """Each rank renders its slice of the lanes; the image (and the spp
    map) reaching every rank is the single-process one, bit for bit."""
    two, _, one = runs
    want = _load(one, tag, 0)
    for rank in (0, 1):
        got = _load(two, tag, rank)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{tag} {k} rank {rank}")


def _loss_keys(tag):
    return ["out.0"] if tag.startswith(("grads", "fused")) else ["out.1"]


@pytest.mark.parametrize("tag", GRADIENT)
def test_sharded_gradients_within_jax_bounds(runs, tag):
    """The loss within rtol 1e-6, every gradient, parameter and moment
    within rtol 1e-4 / atol 1e-7 of the single-process step (JAX's
    bounds); integers and the fused step's image equal; the ranks hold
    the same bits, and each rank's two runs gave the same bits."""
    two, status, one = runs
    want = _load(one, tag, 0)
    got = _load(two, tag, 0)
    assert got.keys() == want.keys()
    for k in want:
        if k in _loss_keys(tag):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=f"{tag} {k}")
        elif want[k].dtype.kind in "iub" or (tag == "fused"
                                             and k == "out.1"):
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{tag} {k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-7, err_msg=f"{tag} {k}")
    other = _load(two, tag, 1)
    for k in got:
        np.testing.assert_array_equal(got[k], other[k], err_msg=f"{tag} {k}")
    assert all(_rec(status, r, tag)["runs_bit_identical"] for r in (0, 1))


@pytest.mark.parametrize("tag, calls", [
    ("fused", 1), ("train_fused", 1), ("stream_train", 1),
    ("grads_oracle", 2), ("grads_oracle_f64", 2), ("grads_kernel", 2),
    ("train_oracle", 2),
    ("train_kernel", 2), ("stream_train_2p", 2)])
def test_all_reduces_a_step(runs, tag, calls):
    """A fused step makes one all_reduce (the loss and the cotangents in
    one flat buffer); the oracle, kernel 3 and two-program steps make two
    (the image's exact gather, then the cotangents')."""
    _, status, _ = runs
    for rank in (0, 1):
        assert _rec(status, rank, tag)["all_reduces_a_step"] == calls


def test_fused_step_collective_profile(runs):
    """The counterpart of JAX's HLO check: the fused step's one
    all_reduce carries the loss (1), d_scene_mat (slots x 16) and
    d_cam_row (24), and the image's 3 x padded lanes (each rank's pixels
    in a zero-filled image: an exact gather in the same collective)."""
    from raytracingincuda_torch.models.scene import build_scene

    _, status, _ = runs
    slots = build_scene(2, device="cpu").num_slots
    padded = meshlib.padded_lanes(W * H, meshlib.Mesh(None, 0, 2, None,
                                                      ("dp",), (2,)))
    assert _rec(status, 0, "fused")["all_reduce_numel"] == [
        1 + slots * 16 + 24 + 3 * padded]
    assert _rec(status, 0, "stream_train")["all_reduce_numel"][0] > 1 + 24


def test_sharded_render_against_jax_pixel_sharding(runs):
    """The port's sharded oracle image against the JAX oracle sharded
    over the conftest's 8 CPU devices (``pixel_sharding``), through the
    cross-framework gate (XLA fuses multiply-adds)."""
    import jax

    from raytracingincuda_torch.utils import ppm
    from raytracingincuda_tpu.models.camera import CameraConfig
    from raytracingincuda_tpu.models.scene import build_scene
    from raytracingincuda_tpu.ops.tracer import render
    from raytracingincuda_tpu.parallel import mesh as jmesh

    two, _, _ = runs
    sh = jmesh.pixel_sharding(jmesh.make_mesh())
    want = np.asarray(jax.jit(lambda s, c: render(
        s, c, W, H, SPP, DEPTH, chunk_pixels=2048, pixel_sharding=sh))(
        build_scene(2), CameraConfig.reference_default()))
    got = _load(two, "oracle", 0)["out"]
    st = ppm.diff_stats(got, ppm.quantize(want))
    assert ppm.passes_cross_framework_gate(st), st


def test_mesh_refusals(monkeypatch):
    """nccl with two ranks on one device (here: none) names gloo; a
    device count other than the launched world raises; the f64 kernel
    takes no mesh, while the f64 oracle does."""
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="gloo"):
        meshlib.maybe_initialize_distributed("nccl")
    assert not torch.distributed.is_initialized()
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k)
    cfg = RenderConfig(scene_id=2, width=W, height=H)
    with pytest.raises(ValueError, match="n_devices=2"):
        make_renderer(cfg, "cpu", n_devices=2)
    with pytest.raises(ValueError, match="n_devices=3"):
        meshlib.make_mesh(3)
    with pytest.raises(ValueError, match="at most 2 mesh axes"):
        meshlib.make_mesh(axis_names=("a", "b", "c"))
    fake = meshlib.Mesh(None, 0, 2, torch.device("cpu"), ("dp",), (2,))
    monkeypatch.setattr(meshlib, "world_size", lambda: 2)
    monkeypatch.setattr(meshlib, "make_mesh", lambda *a, **k: fake)
    with pytest.raises(ValueError, match="f64 kernel"):
        make_renderer(RenderConfig(scene_id=2, dtype="float64"), "cpu")
    make_renderer(RenderConfig(scene_id=2, dtype="float64", impl="oracle"),
                  "cpu")
    with pytest.raises(ValueError, match="multiple of 128 x 2"):
        meshlib.lane_slice(384, 2, 0)
    assert meshlib.lane_slice(512, 2, 1) == slice(256, 512)


def test_no_cpu_fallback(monkeypatch, tmp_path):
    """Without CUDA, the default device (None: 'cuda') raises and names
    device='cpu', in rank_device, make_mesh and the worker without
    --device; 'cpu' is the CPU. make_mesh's argument checks come first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (meshlib.rank_device, lambda: meshlib.rank_device("cuda"),
                 meshlib.make_mesh,
                 lambda: worker.main(["--outdir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert os.listdir(tmp_path) == []
    assert meshlib.rank_device("cpu") == torch.device("cpu")
    assert meshlib.make_mesh(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="n_devices=3"):
        meshlib.make_mesh(3)
    with pytest.raises(ValueError, match="at most 2 mesh axes"):
        meshlib.make_mesh(axis_names=("a", "b", "c"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card: kernel 1 renders each rank's lanes
    and the image equals one process's render on the card, bit for bit;
    kernel 7 likewise."""
    from raytracingincuda_torch.models.camera import CameraConfig
    from raytracingincuda_torch.models.scene import build_scene
    from raytracingincuda_torch.ops import render_kernel as rk

    shape = dict(scene_id=1, width=320, height=192, samples=4, bounces=8)
    jobs = [dict(job="render", impl="kernel", tag="kernel", **shape),
            dict(job="kernel", mode="compact", tag="compact", **shape)]
    path = tmp_path / "jobs.json"
    path.write_text(json.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = worker.torchrun(
        ["-m", "raytracingincuda_torch.parallel.worker", "--device", "cuda",
         "--backend", "gloo", "--outdir", str(tmp_path), "--jobs",
         str(path)], timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-4000:]
    status = json.loads(res.stdout.strip().splitlines()[-1])["ranks"]
    scene, cam = build_scene(1, device=cuda), CameraConfig.reference_default()
    args = (320, 192, 4, 8)
    want = {"kernel": make_renderer(RenderConfig(**shape), cuda)(scene, cam),
            "compact": rk.render_kernel(scene, cam, *args, mode="compact")}
    for tag, launched in (("kernel", "regen_render"),
                          ("compact", "compact_render")):
        for rank in (0, 1):
            got = _load(str(tmp_path), tag, rank)["out"]
            np.testing.assert_array_equal(got, want[tag].cpu().numpy())
            assert _rec(status, rank, tag)["launches"][launched] >= 1
