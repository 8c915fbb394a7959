"""Scene assets (models/io.py) and the serial baseline's scene
(models/reference_scene.py) against the JAX package.

Twins of ``tests/test_scene_io.py``, files written by each package and
read by the other (arrays equal), and the serial scene equal to JAX's
and to its sha256 pin. Renders run the regen kernel's plain version.
"""
import hashlib

import numpy as np
import pytest
import torch

from raytracingincuda_torch.models import io as tio
from raytracingincuda_torch.models import reference_scene as tref
from raytracingincuda_torch.models.camera import CameraConfig
from raytracingincuda_torch.models.scene import (DIELECTRIC, LAMBERTIAN,
                                                 METAL, build_scene)
from raytracingincuda_torch.ops import render_kernel as rk

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)


def _active_arrays(scene):
    """Active slots' arrays of a scene of either package, as numpy."""
    keep = np.flatnonzero(np.asarray(scene.active))
    p = scene.params

    def a(x):
        return np.asarray(x)[keep]

    return {
        "center": np.stack([a(p.center.x), a(p.center.y), a(p.center.z)], 1),
        "radius": a(p.radius),
        "albedo": np.stack([a(p.albedo.x), a(p.albedo.y), a(p.albedo.z)], 1),
        "fuzz": a(p.fuzz), "ior": a(p.ior), "mat": a(scene.mat_type),
    }


def _all_arrays(scene):
    p = scene.params
    return [np.asarray(t) for t in (*p.center, p.radius, *p.albedo, p.fuzz,
                                    p.ior, scene.mat_type, scene.active)]


@pytest.mark.parametrize("ext", ["npz", "csv"])
def test_round_trip(tmp_path, ext):
    scene = build_scene(2, device="cpu")
    path = str(tmp_path / f"scene2.{ext}")
    tio.save_scene(path, scene)
    loaded = tio.load_scene(path, device="cpu")
    a, b = _active_arrays(scene), _active_arrays(loaded)
    for k in a:     # f32 storage and 9 significant digits are exact
        np.testing.assert_array_equal(a[k], b[k])
    assert loaded.num_slots % 128 == 0
    assert loaded.params.radius.dtype == torch.float32


def test_csv_hand_written(tmp_path):
    path = tmp_path / "tiny.csv"
    path.write_text(
        "# a comment\n"
        "\n"
        "0,-1000,0,1000,lambertian,0.5,0.5,0.5,0,1\n"
        "0,1,0,1,dielectric,0,0,0,0,1.5\n"
        "4,1,0,1,metal,0.7,0.6,0.5,0.1,1\n"
        "2,1,0,1,1,0.9,0.9,0.9,0.2,1\n"     # integer mat id
        "-2,1,0,1,Dieletric,0,0,0,3.0,1.3\n"  # the reference's spelling
    )
    a = _active_arrays(tio.load_scene(str(path), device="cpu"))
    assert a["mat"].tolist() == [LAMBERTIAN, DIELECTRIC, METAL, METAL,
                                 DIELECTRIC]
    np.testing.assert_allclose(a["ior"], [1.0, 1.5, 1.0, 1.0, 1.3],
                               rtol=1e-7)
    # fuzz is clamped at 1, as the reference's metal constructor does
    np.testing.assert_allclose(a["fuzz"], [0.0, 0.0, 0.1, 0.2, 1.0],
                               rtol=1e-7)


def test_csv_errors(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2,3\n")
    with pytest.raises(ValueError, match="expected 10 fields"):
        tio.load_scene(str(bad), device="cpu")
    empty = tmp_path / "empty.csv"
    empty.write_text("# nothing\n")
    with pytest.raises(ValueError, match="no spheres"):
        tio.load_scene(str(empty), device="cpu")
    with pytest.raises(ValueError, match="unsupported scene format"):
        tio.load_scene(str(tmp_path / "scene.obj"), device="cpu")
    with pytest.raises(ValueError, match="unsupported scene format"):
        tio.save_scene(str(tmp_path / "scene.obj"),
                       build_scene(2, device="cpu"))


def test_scene_from_arrays_defaults_and_validation():
    s = tio.scene_from_arrays(center=[[0, 0, -1]], radius=[0.5],
                              mat_type=[LAMBERTIAN], pad_to_multiple=8,
                              device="cpu")
    assert s.num_slots == 8
    assert int(s.active.sum()) == 1
    # parked padding never hits: far below the world
    assert float(s.params.center.y[-1]) == -1.0e6
    with pytest.raises(ValueError, match="mat_type"):
        tio.scene_from_arrays([[0, 0, 0]], [1.0], [7], device="cpu")
    with pytest.raises(ValueError, match="radius"):
        tio.scene_from_arrays([[0, 0, 0]], [0.0], [0], device="cpu")
    with pytest.raises(ValueError, match="ior"):
        tio.scene_from_arrays([[0, 0, 0]], [1.0], [2], ior=[0.0], device="cpu")


def test_scene_from_arrays_equals_jax():
    """The same host arrays give the same padded f32 scene in both
    packages, with an active mask; a float64 scene keeps the fuzz clamp."""
    from raytracingincuda_tpu.models import io as jio
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    n = 150
    arrays = dict(center=rng.normal(0, 3, (n, 3)),
                  radius=rng.uniform(-1, 1, n) + 1.5,
                  mat_type=rng.integers(0, 3, n),
                  albedo=rng.random((n, 3)), fuzz=rng.uniform(0, 2, n),
                  ior=rng.uniform(1, 2, n), active=rng.random(n) < 0.9)
    got = _all_arrays(tio.scene_from_arrays(**arrays, device="cpu"))
    want = _all_arrays(jio.scene_from_arrays(dtype=jnp.float32, **arrays))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    got = tio.scene_from_arrays(dtype=torch.float64, pad_to_multiple=None,
                                **arrays, device="cpu")
    assert got.num_slots == n and got.params.fuzz.dtype == torch.float64
    np.testing.assert_array_equal(got.params.fuzz.numpy(),
                                  np.minimum(arrays["fuzz"], 1.0))


@pytest.mark.parametrize("ext", ["npz", "csv"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_cross_between_packages(tmp_path, ext, writer):
    """A file written by either package loads in the other to the same
    arrays and slot count; the csv files are the same bytes."""
    from raytracingincuda_tpu.models import io as jio
    from raytracingincuda_tpu.models.scene import build_scene as j_build

    path = str(tmp_path / f"scene1.{ext}")
    if writer == "jax":
        jio.save_scene(path, j_build(1))
    else:
        tio.save_scene(path, build_scene(1, device="cpu"))
    got, want = tio.load_scene(path, device="cpu"), jio.load_scene(path)
    assert got.num_slots == want.num_slots == 512
    for g, w in zip(_all_arrays(got), _all_arrays(want)):
        np.testing.assert_array_equal(g, w)
    a, b = _active_arrays(got), _active_arrays(build_scene(1, device="cpu"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    if ext == "csv":
        other = str(tmp_path / "other.csv")
        (tio.save_scene(other, build_scene(1, device="cpu")) if writer == "jax"
         else jio.save_scene(other, j_build(1)))
        with open(path, "rb") as f1, open(other, "rb") as f2:
            assert f1.read() == f2.read()


def test_loaded_scene_renders_identically(tmp_path):
    """A saved and loaded scene 1 (its inactive grid slots dropped, the
    active ones in the same order) renders the same bits as the built one
    on the plain version."""
    scene, cam = build_scene(1, device="cpu"), CameraConfig.reference_default()
    path = str(tmp_path / "s.npz")
    tio.save_scene(path, scene)
    loaded = tio.load_scene(path, device="cpu")
    assert int(loaded.active.sum()) == int(scene.active.sum())
    assert not torch.equal(loaded.active, scene.active)  # slots moved
    assert torch.equal(rk.render_kernel(loaded, cam, 32, 20, 2, 4),
                       rk.render_kernel(scene, cam, 32, 20, 2, 4))


def test_serial_scene_equals_jax_and_pin():
    """The glibc rand() replay: the same float64 arrays as the JAX
    package's, their sha256 the pin, 487 spheres in 512 slots."""
    from raytracingincuda_tpu.models import reference_scene as jref

    got, want = tref.serial_scene1_arrays(), jref.serial_scene1_arrays()
    h = hashlib.sha256()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        h.update(np.ascontiguousarray(g, np.float64).tobytes())
    assert h.hexdigest() == tref.SERIAL_SCENE1_SHA256
    assert tref.SERIAL_SCENE1_SHA256 == (
        "aca58f22a147bd5a5c86f8d347b33f22026bd110e6ba19a99e47d5b83016a0f8")
    scene = tref.build_serial_reference_scene(device="cpu")
    assert got[0].shape[0] == 487
    assert int(scene.active.sum()) == 487 and scene.num_slots == 512
    for g, w in zip(_all_arrays(scene),
                    _all_arrays(jref.build_serial_reference_scene())):
        np.testing.assert_array_equal(g, w)
    first = list(zip(range(5), tref._glibc_rand()))
    assert [v for _, v in first] == [1804289383, 846930886, 1681692777,
                                     1714636915, 1957747793]
