"""The port's scenes, camera and state conversion against the JAX package.

Scene arrays come from the same numpy builder: bit-equal. The camera is
derived with ``tan`` on each side (XLA's and PyTorch's may differ by an
ulp): allclose(rtol=1e-6).
"""
import jax
import numpy as np
import pytest
import torch

from raytracingincuda_torch.models import camera as tcam
from raytracingincuda_torch.models import convert
from raytracingincuda_torch.models import scene as tscene
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_tpu.models import camera as jcam
from raytracingincuda_tpu.models import scene as jscene
from raytracingincuda_tpu.ops import pallas_kernel as jpk

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)


def _torch_leaves(s):
    p = s.params
    return [*p.center, p.radius, *p.albedo, p.fuzz, p.ior, s.mat_type,
            s.active]


def _jax_leaves(s):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(s)]


def _assert_scene_equal(jax_scene, torch_scene):
    jl, tl = _jax_leaves(jax_scene), _torch_leaves(torch_scene)
    assert len(jl) == len(tl) == 11
    for a, b in zip(jl, tl):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("scene_id", [1, 2, 3])
def test_build_scene_bit_equal(scene_id):
    _assert_scene_equal(jscene.build_scene(scene_id),
                        tscene.build_scene(scene_id))


@pytest.mark.parametrize("kw", [dict(pad_to_multiple=64), dict(seed=7),
                                dict(pad_to_multiple=None)])
def test_build_scene_options_bit_equal(kw):
    _assert_scene_equal(jscene.build_scene(2, **kw),
                        tscene.build_scene(2, **kw))


def test_build_random_scene_bit_equal():
    _assert_scene_equal(jscene.build_random_scene(300, seed=5),
                        tscene.build_random_scene(300, seed=5))


@pytest.mark.parametrize("scene_id", [1, 3])
def test_pack_scene_matrix_bit_equal(scene_id):
    want = np.asarray(jpk.pack_scene_matrix(jscene.build_scene(scene_id)))
    got = rk.pack_scene_matrix(tscene.build_scene(scene_id)).numpy()
    np.testing.assert_array_equal(got, want)


def test_scene_from_numpy_equals_build_scene():
    js = jscene.build_scene(1)
    got = convert.scene_from_numpy(_jax_leaves(js))
    want = tscene.build_scene(1)
    for a, b in zip(_torch_leaves(got), _torch_leaves(want)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        convert.scene_from_numpy(_jax_leaves(js)[:10])


@pytest.mark.parametrize("wh", [(48, 30), (1280, 768), (17, 5)])
def test_initialize_allclose(wh):
    jc = jcam.initialize(jcam.CameraConfig.reference_default(), *wh)
    tc = tcam.initialize(tcam.CameraConfig.reference_default(), *wh)
    for jv, tv in zip(jc[:-1], tc[:-1]):
        np.testing.assert_allclose(torch.stack(list(tv)).numpy(),
                                   np.asarray(jv), rtol=1e-6, atol=1e-7)
    assert bool(jc.use_defocus) == bool(tc.use_defocus)


def test_camera_config_from_numpy_equals_default():
    leaves = _jax_leaves(jcam.CameraConfig.reference_default())
    got = convert.camera_config_from_numpy(leaves)
    want = tcam.CameraConfig.reference_default()
    assert torch.equal(got.vfov, want.vfov)
    for a, b in zip([*got.lookfrom, *got.lookat, *got.vup],
                    [*want.lookfrom, *want.lookat, *want.vup]):
        assert torch.equal(a, b)


def test_camera_row_round_trip():
    """The JAX pack_camera row crosses unchanged, unpacks to the camera it
    packs, and equals the port's own row for the reference camera."""
    jrow = np.asarray(jpk.pack_camera(
        jcam.initialize(jcam.CameraConfig.reference_default(), 48, 30)))
    row = convert.camera_row_from_numpy(jrow)
    np.testing.assert_array_equal(row.numpy(), jrow)
    np.testing.assert_array_equal(
        rk.pack_camera(rk.unpack_camera(row)).numpy(), jrow)
    own = rk.pack_camera(
        tcam.initialize(tcam.CameraConfig.reference_default(), 48, 30))
    np.testing.assert_allclose(own.numpy(), jrow, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        convert.camera_row_from_numpy(jrow[:, :20])
