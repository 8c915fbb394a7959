"""Deep paths (see test_torch_deep.py): kernel B's plain version against
``mse_train_pallas`` in interpret mode at depths 100 and 256."""
import numpy as np
import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.ops import train_kernel as tk
from test_torch_deep import (  # noqa: F401 (deep, target: fixtures)
    CASES, GRAD_FRAC, LOSS_RTOL, SPP, H, W, _close, _kept, _mse_cotangent,
    deep, target)

torch.set_num_threads(1)


@pytest.mark.parametrize("depth,rr", CASES)
def test_deep_fused_train_matches_mse_train_pallas(deep, target, depth, rr):
    """Kernel B's plain version (``fused_train``, gamma, MSE) vs
    ``mse_train_pallas`` in interpret mode: the kept pixels' image within
    1e-5, the loss without the dropped pixels' terms to 1e-5, the
    gradients without the dropped pixels' contributions to 1e-3 of the
    largest entry."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.ops.pallas_backward import (mse_train_pallas,
                                                          render_pallas_grads)

    js, ts = deep
    jcam, tcam = JCam.reference_default(), TCam.reference_default()
    want = mse_train_pallas(js, jcam, jnp.asarray(target), W, H, SPP, depth,
                            interpret=True, park_residuals="hbm",
                            ray_tile=128, rr_start=rr)
    got = tk.fused_train(ts, tcam, torch.from_numpy(target), W, H, SPP, depth,
                         rr_start=rr)
    img_j, img_p = np.asarray(want[1]), got[1].numpy()
    keep = _kept(ts, img_p, img_j, depth, rr)
    drop = ~keep
    terms_j, g_j = _mse_cotangent(img_j, target, True)
    terms_p, g_p = _mse_cotangent(img_p, target, True)
    w = 1.0 / (W * H * 3)
    np.testing.assert_allclose(float(got[0]) - w * terms_p[drop].sum(),
                               float(want[0]) - w * terms_j[drop].sum(),
                               rtol=LOSS_RTOL)
    d_sm_j, d_cr_j = np.asarray(want[2]), np.asarray(want[3])
    d_sm_p, d_cr_p = got[2].numpy(), got[3].numpy()
    if drop.any():
        sub_j = render_pallas_grads(
            js, jcam, jnp.asarray(g_j * drop[..., None]), W, H, SPP, depth,
            interpret=True, park="hbm", ray_tile=128, rr_start=rr)
        sub_p = tk.render_kernel_grads(
            ts, tcam, torch.from_numpy(g_p * drop[..., None]), W, H, SPP,
            depth, rr_start=rr)
        d_sm_j, d_cr_j = d_sm_j - np.asarray(sub_j[0]), d_cr_j - np.asarray(
            sub_j[1])
        d_sm_p, d_cr_p = d_sm_p - sub_p[0].numpy(), d_cr_p - sub_p[1].numpy()
    _close(d_sm_p, d_sm_j, GRAD_FRAC, "d_scene_mat")
    _close(d_cr_p, d_cr_j, GRAD_FRAC, "d_cam_row")
