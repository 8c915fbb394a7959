"""The port's entry points: config, make_renderer, the CLI, and the rule
that nothing in ``raytracingincuda_torch`` imports JAX."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracingincuda_torch import cli
from raytracingincuda_torch.config import RenderConfig
from raytracingincuda_torch.models.camera import CameraConfig
from raytracingincuda_torch.models.scene import build_scene
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import tracer
from raytracingincuda_torch.render_api import make_renderer
from raytracingincuda_torch.utils import ppm

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("rr_start", [None, 2])
def test_make_renderer_cpu_equals_plain_version(rr_start, monkeypatch):
    """samples >= 8 and bounces > 4: the renderer runs no difficulty
    prepass (kernel 1 renders in raster order), and its image is the plain
    version's."""
    cfg = RenderConfig(scene_id=2, width=20, height=12, samples=8, bounces=5,
                       rr_start=rr_start)
    scene, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    calls = []
    real = rk.measure_difficulty
    monkeypatch.setattr(rk, "measure_difficulty",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    img = make_renderer(cfg, "cpu")(scene, cam)
    assert calls == []
    inputs = rk.regen_inputs(scene, cam, 20, 12, 8)
    want = rk.regen_reference(*inputs, samples=8, max_depth=5,
                              rr_start=rr_start, finalize_scale=1 / 8)
    assert img.shape == (12, 20, 3)
    assert torch.equal(img, want.t()[:240].reshape(12, 20, 3))


def test_make_renderer_oracle_impl():
    cfg = RenderConfig(scene_id=3, width=16, height=8, samples=2, bounces=4,
                       impl="oracle")
    scene, cam = build_scene(3, device="cpu"), CameraConfig.reference_default()
    want = tracer.render(scene, cam, 16, 8, 2, 4)
    assert torch.equal(make_renderer(cfg, "cpu")(scene, cam), want)


def test_make_renderer_order_cache_by_shape(monkeypatch):
    """A rebuilt scene of the same shapes reuses the prepass order (the
    stream renderer orders one-block scenes)."""
    cfg = RenderConfig(scene_id=2, width=16, height=8, samples=8, bounces=5,
                       impl="stream")
    r = make_renderer(cfg, "cpu")
    cam = CameraConfig.reference_default()
    calls = []
    real = rk.measure_difficulty
    monkeypatch.setattr(rk, "measure_difficulty",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    first = r(build_scene(2, device="cpu"), cam)
    assert calls == [1]
    assert torch.equal(r(build_scene(2, device="cpu"), cam), first)
    assert calls == [1]


@pytest.mark.parametrize("kw, exc", [
    (dict(dtype="float64", rr_start=2), ValueError),
    (dict(dtype="bfloat16"), ValueError),
    (dict(impl="adaptive", samples=3), ValueError),
    (dict(impl="stream", dtype="float64"), ValueError),
    (dict(impl="pallas"), ValueError),
    (dict(layout="packed", dtype="float64"), ValueError),
    (dict(mxu_dots=True), ValueError),
    (dict(samples=0), ValueError),
    (dict(impl="stream", stream_block=0), ValueError),
    (dict(layout="packed", stream_lane_group=-1), ValueError),
])
def test_config_rejects(kw, exc):
    with pytest.raises(exc):
        RenderConfig(scene_id=1, **kw)


@pytest.mark.parametrize("kw, block", [
    (dict(impl="stream"), 128),
    (dict(layout="packed", rr_start=2), 128),
    (dict(impl="stream", samples=2), 128),
])
def test_stream_configs_render_on_cpu(kw, block):
    """impl='stream' and layout='packed' (which routes to the stream path,
    as in JAX) build and render: one block for a small scene, the image
    equal to the brute-force plain render; the difficulty order at >= 8
    spp changes nothing; ``prepare`` runs the preparation ahead; the
    file name says 'tex' for packed."""
    cfg = RenderConfig(scene_id=2, width=20, height=12,
                       **{"samples": 8, "bounces": 5, **kw})
    scene, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    r = make_renderer(cfg, "cpu")
    r.prepare(scene)
    img = r(scene, cam)
    want = rk.render_kernel(scene, cam, 20, 12, cfg.samples, 5, layout="hbm",
                            rr_start=cfg.rr_start)
    assert torch.equal(img, want)
    assert cfg.output_filename().startswith(
        "tex_" if cfg.layout == "packed" else "const_")
    with pytest.raises(ValueError, match="legacy_sky"):
        make_renderer(RenderConfig(scene_id=2, legacy_sky=True, **kw), "cpu")


def _adaptive_cfg(**kw):
    return RenderConfig(scene_id=2, width=32, height=20, samples=4,
                        bounces=4, impl="adaptive", max_samples=16, **kw)


@pytest.mark.parametrize("legacy_sky", [False, True])
def test_adaptive_packed_renders_adaptively(legacy_sky, monkeypatch):
    """impl='adaptive' takes the adaptive renderer whatever the layout, as
    JAX's does (only impl 'pallas' remaps 'packed' to the stream kernel):
    with layout='packed' it calls render_adaptive once, and its image is
    the layout='vmem' adaptive image bit for bit. With legacy_sky it
    renders, held to JAX's make_renderer under the cross-framework gate:
    at this shape the two packages' budgets agree, and 4 of the 640
    pixels take another path after a knife-edge bounce under XLA's fused
    multiply-adds (0.024 at most, with or without legacy_sky)."""
    from raytracingincuda_torch.ops import adaptive

    calls = []
    real = adaptive.render_adaptive
    monkeypatch.setattr(adaptive, "render_adaptive",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    scene, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    img = make_renderer(_adaptive_cfg(layout="packed", legacy_sky=legacy_sky),
                        "cpu")(scene, cam)
    assert calls == [1]
    want = make_renderer(_adaptive_cfg(layout="vmem", legacy_sky=legacy_sky),
                         "cpu")(scene, cam)
    assert torch.equal(img, want)
    if legacy_sky:
        from raytracingincuda_tpu.config import RenderConfig as JaxConfig
        from raytracingincuda_tpu.models.camera import \
            CameraConfig as JaxCamera
        from raytracingincuda_tpu.models.scene import \
            build_scene as jax_scene
        from raytracingincuda_tpu.render_api import \
            make_renderer as jax_renderer

        jcfg = JaxConfig(scene_id=2, width=32, height=20, samples=4,
                         bounces=4, impl="adaptive", max_samples=16,
                         layout="packed", legacy_sky=True)
        jimg = jax_renderer(jcfg, n_devices=1)(
            jax_scene(2), JaxCamera.reference_default())
        stats = ppm.diff_stats(img.numpy(), ppm.quantize(np.asarray(jimg)))
        assert ppm.passes_cross_framework_gate(stats), stats


def test_cli_stream_writes_tex_file(tmp_path, capsys):
    rc = cli.main(["--scene_id", "2", "--width", "16", "--height", "8",
                   "--samples", "2", "--bounces", "3", "--device", "cpu",
                   "--layout", "packed", "--stream_block", "64",
                   "--outdir", str(tmp_path)])
    assert rc == 0
    assert len(capsys.readouterr().out.strip().split(",")) == 2
    assert os.listdir(tmp_path) == [
        "tex_float_scene2_16x8_2samples_3bounces_8threadsPerBlockRow.ppm"]


def test_output_filename_matches_jax_package():
    from raytracingincuda_tpu.config import RenderConfig as JaxConfig

    for kw in (dict(), dict(layout="hbm", width=1280, height=768,
                            samples=100, threads=16)):
        assert (RenderConfig(scene_id=1, **kw).output_filename()
                == JaxConfig(scene_id=1, **kw).output_filename())


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_renderer(RenderConfig(scene_id=1), "cuda")


def test_renderer_rejects_scene_on_other_device():
    r = make_renderer(RenderConfig(scene_id=2, samples=2), "cpu")
    scene = build_scene(2, device="meta")
    with pytest.raises(ValueError):
        r(scene, CameraConfig.reference_default())


def test_cli_cpu_writes_reference_file(tmp_path, capsys):
    rc = cli.main(["--scene_id", "2", "--width", "24", "--height", "16",
                   "--samples", "2", "--bounces", "4", "--device", "cpu",
                   "--outdir", str(tmp_path), "--pixels_per_lane", "4"])
    assert rc == 0
    fields = capsys.readouterr().out.strip().split(",")
    assert len(fields) == 2 and all(float(f) > 0 for f in fields)
    name = "const_float_scene2_24x16_2samples_4bounces_8threadsPerBlockRow.ppm"
    assert os.listdir(tmp_path) == [name]
    with open(tmp_path / name) as f:
        assert f.readline() == "P3\n" and f.readline() == "24 16\n"


def test_cli_scene_file_renders_the_asset(tmp_path, capsys):
    """--scene_file renders a saved .npz asset to the bytes --scene_id
    writes for the same scene, under the file name of scene 0 (as the JAX
    CLI names it); without either flag the CLI refuses."""
    from raytracingincuda_torch.models.io import save_scene

    save_scene(str(tmp_path / "s2.npz"), build_scene(2, device="cpu"))
    common = ["--width", "24", "--height", "16", "--samples", "2",
              "--bounces", "4", "--device", "cpu", "--no-warmup"]
    for flags, out in ((["--scene_file", str(tmp_path / "s2.npz")], "f"),
                       (["--scene_id", "2"], "i")):
        os.makedirs(tmp_path / out)
        assert cli.main([*flags, *common, "--outdir",
                         str(tmp_path / out)]) == 0
    capsys.readouterr()
    name = "const_float_scene{}_24x16_2samples_4bounces_8threadsPerBlockRow.ppm"
    assert os.listdir(tmp_path / "f") == [name.format(0)]
    assert ((tmp_path / "f" / name.format(0)).read_bytes()
            == (tmp_path / "i" / name.format(2)).read_bytes())
    assert cli.main(common) == 1
    assert "--scene_file" in capsys.readouterr().err


def test_cli_adaptive_renders(tmp_path, capsys):
    """--impl adaptive with its flags renders the renderer's image."""
    rc = cli.main(["--scene_id", "2", "--width", "16", "--height", "8",
                   "--samples", "4", "--bounces", "4", "--device", "cpu",
                   "--impl", "adaptive", "--max_samples", "12",
                   "--adaptive_tol", "0.2", "--adaptive_rounds", "2",
                   "--outdir", str(tmp_path)])
    assert rc == 0
    assert len(capsys.readouterr().out.strip().split(",")) == 2
    name = "const_float_scene2_16x8_4samples_4bounces_8threadsPerBlockRow.ppm"
    got, _ = ppm.read_ppm(str(tmp_path / name))
    cfg = RenderConfig(scene_id=2, width=16, height=8, samples=4, bounces=4,
                       impl="adaptive", max_samples=12, adaptive_tol=0.2,
                       adaptive_rounds=2)
    want = make_renderer(cfg, "cpu")(build_scene(2, device="cpu"),
                                     CameraConfig.reference_default())
    assert (got == ppm.quantize(want.numpy())).all()


def test_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import raytracingincuda_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'raytracingincuda_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 15, names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raytracingincuda_tpu'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                             [ROOT, os.environ.get("PYTHONPATH", "")])))
    assert res.returncode == 0, res.stderr
