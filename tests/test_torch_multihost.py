"""Multi-process runs of the port under torchrun, on the CPU.

The counterpart of ``tests/test_multihost.py``: two localhost ranks
(gloo) launched by ``torchrun`` run ``parallel/worker.py`` (the
counterpart of ``benchmarks/multihost_worker.py``): ``make_renderer`` over
the world, per-rank part files, the stitch, byte-identical PPMs against
the single-process render, the oracle's gradients and kernel 2's fused
step (its plain version here) across both ranks. The CLI under
``torchrun --nproc_per_node 2 ... --devices 2`` writes the bytes of the
single-process CLI. Each launch has its own timeout, so a hung
rendezvous fails in seconds.
"""
import json
import os

import numpy as np
import pytest
import torch

from raytracingincuda_torch import cli
from raytracingincuda_torch.config import RenderConfig
from raytracingincuda_torch.models.camera import CameraConfig
from raytracingincuda_torch.models.scene import build_scene
from raytracingincuda_torch.ops import grad as gradlib
from raytracingincuda_torch.ops import train_kernel as tk
from raytracingincuda_torch.parallel import worker
from raytracingincuda_torch.render_api import make_renderer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(scene_id=2, width=64, height=48, samples=2, bounces=4)
JOBS = [dict(job="render", impl="oracle", tag="render_oracle"),
        dict(job="grads", impl="oracle", tag="grads"),
        dict(job="render", impl="kernel", tag="render_kernel"),
        dict(job="fused", tag="fused")]


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multihost"))
    jobs = os.path.join(out, "jobs.json")
    with open(jobs, "w") as f:
        json.dump(JOBS, f)
    flags = [f"--{k}={v}" for k, v in TINY.items()]
    res = worker.torchrun(["-m", "raytracingincuda_torch.parallel.worker",
                           "--device", "cpu", "--outdir", out, "--jobs",
                           jobs, *flags], timeout=300, env=_env(), cwd=out)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, lines       # rank 0 prints the one line
    return out, json.loads(lines[0])["ranks"]


def _rec(status, tag):
    return next(j for j in status["jobs"] if j["tag"] == tag)


def _single(impl):
    cfg = RenderConfig(impl=impl, **TINY)
    return make_renderer(cfg, "cpu")(build_scene(2, device="cpu"),
                                     CameraConfig.reference_default()).numpy()


def _target():
    gen = torch.Generator().manual_seed(0)
    return torch.rand((TINY["height"], TINY["width"], 3), generator=gen)


def test_multihost_oracle_render_stitch_grads(probe):
    out, status = probe
    assert [s["world"] for s in status] == [2, 2]
    rec = _rec(status[0], "render_oracle")
    assert rec["ppm_identical"]
    parts = [_rec(s, "render_oracle")["part_pixels"] for s in status]
    assert parts == [[0, 1536], [1536, 3072]]
    got = np.load(os.path.join(out, "render_oracle_r1.npz"))["out"]
    assert float(np.abs(got - _single("oracle")).max()) == 0.0
    # the cross-rank gradient all_reduce gave a real, finite gradient,
    # the single-process one within JAX's bounds
    z = np.load(os.path.join(out, "grads_r0.npz"))
    norm = sum(float((z[k] ** 2).sum()) for k in z.files if k != "out.0")
    assert np.isfinite(norm) and norm > 0.0
    loss, (gp, gc) = gradlib.render_grads(
        build_scene(2, device="cpu"), CameraConfig.reference_default(),
        _target(),
        TINY["width"], TINY["height"], TINY["samples"], TINY["bounces"])
    np.testing.assert_allclose(z["out.0"], loss.numpy(), rtol=1e-6)
    np.testing.assert_allclose(z["out.1.0.radius"], gp.radius.numpy(),
                               rtol=1e-4, atol=1e-7)


def test_multihost_kernel_fused_step(probe):
    """The kernel route's render and kernel 2's fused step over both
    ranks: identical PPM bytes through the stitch, the single-process
    image, and the fused step's loss and cotangents close to one
    process's (one all_reduce a step)."""
    out, status = probe
    assert _rec(status[0], "render_kernel")["ppm_identical"]
    got = np.load(os.path.join(out, "render_kernel_r0.npz"))["out"]
    assert float(np.abs(got - _single("kernel")).max()) == 0.0
    assert all(_rec(s, "fused")["all_reduces_a_step"] == 1 for s in status)
    z = np.load(os.path.join(out, "fused_r0.npz"))
    s = build_scene(2, device="cpu")
    step = tk.make_mse_train(s.mat_type, s.active, TINY["width"],
                             TINY["height"], TINY["samples"],
                             TINY["bounces"], gamma=True)
    loss, img, (dp, dc) = step(s.params, CameraConfig.reference_default(),
                               _target())
    np.testing.assert_allclose(z["out.0"], loss.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(z["out.1"], img.numpy())
    np.testing.assert_allclose(z["out.2.0.albedo.x"], dp.albedo.x.numpy(),
                               rtol=1e-4, atol=1e-7)
    assert float(np.linalg.norm(z["out.2.0.center.x"])) > 0.0


def test_torchrun_cli_bytes_equal_single_process(tmp_path, capsys):
    flags = ["--scene_id", "2", "--width", "40", "--height", "24",
             "--samples", "2", "--bounces", "4", "--device", "cpu",
             "--no-warmup"]
    two = tmp_path / "two"
    two.mkdir()
    res = worker.torchrun(["-m", "raytracingincuda_torch.cli", "--devices",
                           "2", *flags, "--outdir", str(two)], timeout=240,
                          env=_env(), cwd=str(two))
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1 and len(lines[0].split(",")) == 2, lines
    one = tmp_path / "one"
    one.mkdir()
    assert cli.main([*flags, "--outdir", str(one)]) == 0
    name = RenderConfig(scene_id=2, width=40, height=24, samples=2,
                        bounces=4).output_filename()
    assert (two / name).read_bytes() == (one / name).read_bytes()
