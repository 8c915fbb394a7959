"""Deep paths: the train kernels' plain versions past the shallow stack's
64 bounces, up to the sampler's 256, against the JAX package.

The deep scene is a white diffuse sphere inside a concentric glass shell
of index 4 (``models/scene.py:build_deep_scene``), with the camera in the
gap: paths that meet the shell at more than 14.5 degrees from its normal
are held by total internal reflection, and a path banks its radiance only
when it escapes through the shell. At 8x4x2spp and depth 256, 15 of the 61 paths
that bank radiance end beyond bounce 64 at parity, 9 of 53 at rr2
(measured). The scene goes through ``models/io.py``'s ``.npz``, which
both packages read.

Why not a cloud of small fuzzy metal and glass spheres: among convex
scatterers a path's error grows by a factor each bounce, so the one-ulp
differences of XLA's fused multiply-adds (interpret mode compiles the
kernels) send every deep path elsewhere (measured at 300 spheres: 31 of
32 pixels differ at depth 100). Between the core and the shell that growth
is slow, and the JAX oracle run op by op renders what the port renders,
but a few deep paths still meet a knife edge under XLA (a grazing hit or a
total-reflection test; 3 to 6 of 32 pixels here). So each comparison
keeps the pixels whose images agree (within the image tolerance of
tests/test_torch_train_kernel.py), requires at least 24 of the 32 and a
path beyond bounce 64 among them, and holds everything else at the
tolerances the shallow tests use: gradient pairs take a cotangent that is
zero on the dropped pixels; the fused pairs subtract the dropped pixels'
loss terms and, through the gradient kernels of each package, their
cotangents' gradients (gradients are linear in the cotangent).

This file holds the scene, its deep share and the gradient pair; the
fused pairs are in test_torch_deep_train.py and test_torch_deep_stream.py
(three files, so that parallel test workers share them).
"""
import numpy as np
import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.scene import build_deep_scene
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import train_kernel as tk

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

W, H, SPP = 8, 4, 2
IMAGE_ATOL = 1e-5       # tests/test_torch_train_kernel.py's fused image
GRAD_FRAC = 1e-3        # ... and its cotangents, of the largest entry
LOSS_RTOL = 1e-5
MIN_KEPT = 24
CASES = [(depth, rr) for depth in (100, 256) for rr in (None, 2)]


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """(JAX scene, port scene), both loaded from one ``.npz`` of
    ``build_deep_scene`` written by the port's ``save_scene``, padded to 8
    slots."""
    from raytracingincuda_torch.models.io import load_scene, save_scene
    from raytracingincuda_tpu.models.io import load_scene as jload

    path = str(tmp_path_factory.mktemp("deep") / "deep.npz")
    save_scene(path, build_deep_scene(device="cpu"))
    return jload(path, pad_to_multiple=8), load_scene(path, pad_to_multiple=8,
                                                      device="cpu")


@pytest.fixture(scope="module")
def target():
    return np.random.default_rng(11).uniform(0.0, 1.0, (H, W, 3)).astype(
        np.float32)


def _close(got, want, frac, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


def _ends(ts, depth, rr):
    """(SPP, H, W) bounce of each path's miss (0: nothing banked), from
    kernel A's plain version."""
    ids, ii, jj, _, sm, row = rk.regen_inputs(ts, TCam.reference_default(),
                                              W, H, SPP)
    ends = tk.path_ends(ids, ii, jj, sm, row, samples=SPP, max_depth=depth,
                        rr_start=rr)
    return ends[:, :W * H].reshape(SPP, H, W).numpy()


def _kept(ts, img_port, img_jax, depth, rr):
    """The pixels whose images agree, checked: at least MIN_KEPT of them,
    and a path beyond bounce 64 among them."""
    keep = (np.abs(np.asarray(img_port) - np.asarray(img_jax)).max(-1)
            <= IMAGE_ATOL * max(1.0, float(np.abs(img_jax).max())))
    assert keep.sum() >= MIN_KEPT, keep.sum()
    deep_kept = ((_ends(ts, depth, rr) > tk.STACK_SHALLOW).any(0) & keep)
    assert deep_kept.any(), "no kept pixel has a path beyond bounce 64"
    return keep


def _mse_cotangent(img, tgt, gamma):
    """Each pixel's loss term and the MSE cotangent of its radiance SUM
    (H, W, 3), from an image after 1/spp (and gamma)."""
    w = np.float32(1.0 / (W * H * 3))
    diff = (img - tgt).astype(np.float32)
    g = diff * np.float32(2.0 * w)
    if gamma:
        g = np.where(img > 0, (0.5 * g) / np.where(img > 0, img, 1), 0)
    return (diff * diff).sum(-1), (g / SPP).astype(np.float32)


def test_deep_scene_banks_beyond_the_shallow_stack(deep):
    """At least 1% of the paths that bank radiance end beyond bounce 64, at
    parity and rr2 (counted from the plain version's path ends)."""
    _, ts = deep
    for rr in (None, 2):
        ends = _ends(ts, 256, rr)
        banked = ends[ends > 0]
        share = float((banked > tk.STACK_SHALLOW).mean())
        assert banked.size >= W * H and share >= 0.01, (rr, share)
        assert int(banked.max()) <= 256


@pytest.mark.parametrize("depth,rr", CASES)
def test_deep_grad_reference_matches_pallas_grads(deep, depth, rr):
    """Kernel A's plain version vs ``render_pallas_grads`` in interpret
    mode, on the kept pixels' cotangent: 1e-3 of each output's largest
    entry."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.ops.pallas_backward import render_pallas_grads
    from raytracingincuda_tpu.ops.pallas_kernel import render_pallas

    js, ts = deep
    jcam, tcam = JCam.reference_default(), TCam.reference_default()
    img_j = render_pallas(js, jcam, W, H, SPP, depth, interpret=True,
                          accumulate_only=True, rr_start=rr)
    img_p = rk.render_kernel(ts, tcam, W, H, SPP, depth, accumulate_only=True,
                             rr_start=rr)
    keep = _kept(ts, img_p.numpy(), img_j, depth, rr)
    g = np.random.default_rng(12).standard_normal((H, W, 3)).astype(
        np.float32) * keep[..., None]
    want = render_pallas_grads(js, jcam, jnp.asarray(g), W, H, SPP, depth,
                               interpret=True, park="hbm", ray_tile=128,
                               rr_start=rr)
    got = tk.render_kernel_grads(ts, tcam, torch.from_numpy(g), W, H, SPP,
                                 depth, rr_start=rr)
    _close(got[0], want[0], GRAD_FRAC, "d_scene_mat")
    _close(got[1], want[1], GRAD_FRAC, "d_cam_row")
