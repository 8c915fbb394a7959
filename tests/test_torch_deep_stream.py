"""Deep paths (see test_torch_deep.py): the stream step's plain version against
JAX's ``mse_train_stream`` in interpret mode at depths 100 and 256."""
import numpy as np
import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.ops import stream_kernel as sk
from raytracingincuda_torch.ops import stream_train_kernel as stk
from test_torch_deep import (  # noqa: F401 (deep, target: fixtures)
    CASES, GRAD_FRAC, LOSS_RTOL, SPP, H, W, _close, _kept, _mse_cotangent,
    deep, target)

torch.set_num_threads(1)


@pytest.mark.parametrize("depth,rr", CASES)
def test_deep_fused_stream_matches_mse_train_stream(deep, target, depth, rr):
    """The stream step's plain version (``mse_train_stream`` on the CPU:
    ``fused_stream_reference``) vs JAX's ``mse_train_stream`` in interpret
    mode, in stream row order: the kept pixels' images (the stream
    renders) within 1e-5, the loss without the dropped pixels' terms to
    1e-5, d_stream and the camera without the dropped pixels'
    contributions to 1e-3 of the largest entry."""
    import jax.numpy as jnp

    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.ops.pallas_stream import (prepare_stream_scene,
                                                        render_pallas_stream)
    from raytracingincuda_tpu.ops.pallas_stream_backward import (
        mse_train_stream, render_pallas_stream_grads)

    js, ts = deep
    jcam, tcam = JCam.reference_default(), TCam.reference_default()
    st_j, st_p = prepare_stream_scene(js, block=8), sk.prepare_stream_scene(
        ts, block=8)
    want = mse_train_stream(st_j, jcam, jnp.asarray(target), W, H, SPP, depth,
                            interpret=True, ray_tile=128, rr_start=rr)
    got = stk.mse_train_stream(st_p, tcam, torch.from_numpy(target), W, H,
                               SPP, depth, rr_start=rr)
    img_j = np.asarray(render_pallas_stream(st_j, jcam, W, H, SPP, depth,
                                            interpret=True, gamma=False,
                                            rr_start=rr))
    img_p = sk.render_stream(st_p, tcam, W, H, SPP, depth, gamma=False,
                             rr_start=rr).numpy()
    keep = _kept(ts, img_p, img_j, depth, rr)
    drop = ~keep
    terms_j, g_j = _mse_cotangent(img_j, target, False)
    terms_p, g_p = _mse_cotangent(img_p, target, False)
    w = 1.0 / (W * H * 3)
    np.testing.assert_allclose(float(got[0]) - w * terms_p[drop].sum(),
                               float(want[0]) - w * terms_j[drop].sum(),
                               rtol=LOSS_RTOL)
    d_s_j, d_c_j = np.asarray(want[1]), np.asarray(want[2])
    d_s_p, d_c_p = got[1].numpy(), got[2].numpy()
    if drop.any():
        sub_j = render_pallas_stream_grads(
            st_j, jcam, jnp.asarray(g_j * drop[..., None]), W, H, SPP, depth,
            interpret=True, ray_tile=128, rr_start=rr)
        sub_p = stk.render_stream_grads(
            st_p, tcam, torch.from_numpy(g_p * drop[..., None]), W, H, SPP,
            depth, rr_start=rr)
        d_s_j, d_c_j = d_s_j - np.asarray(sub_j[0]), d_c_j - np.asarray(
            sub_j[1])
        d_s_p, d_c_p = d_s_p - sub_p[0].numpy(), d_c_p - sub_p[1].numpy()
    _close(d_s_p, d_s_j, GRAD_FRAC, "d_stream")
    _close(d_c_p, d_c_j, GRAD_FRAC, "d_cam_row")
