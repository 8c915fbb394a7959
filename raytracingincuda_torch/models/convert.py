"""Carry state across from the JAX package as numpy arrays.

The JAX package's ``Scene`` and ``CameraConfig`` are pytrees; their
leaves, each taken with ``np.asarray`` in ``jax.tree_util.tree_leaves``
order, are all that crosses. Nothing here imports JAX.

Scene and train state land on the card unless the caller passes
``device='cpu'`` (``device.resolve_device``). The camera config and the
packed camera row stay host data by default: the renderers move the
camera row to the scene's device themselves.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.vec import Vec3
from .camera import CameraConfig
from .scene import Scene, SceneParams, param_leaves, params_from_leaves


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                        dtype=dtype)


def scene_from_numpy(arrays: Sequence[np.ndarray], device=None) -> Scene:
    """Scene on ``device`` (None: the card) from the 11 leaves of a JAX
    ``Scene``: center x/y/z, radius, albedo x/y/z, fuzz, ior, mat_type,
    active."""
    device = resolve_device(device)
    if len(arrays) != 11:
        raise ValueError(f"a Scene has 11 leaves, got {len(arrays)}")
    cx, cy, cz, radius, ar, ag, ab, fuzz, ior, mat, active = arrays
    return Scene(
        params=SceneParams(
            center=Vec3(_t(cx, device), _t(cy, device), _t(cz, device)),
            radius=_t(radius, device),
            albedo=Vec3(_t(ar, device), _t(ag, device), _t(ab, device)),
            fuzz=_t(fuzz, device),
            ior=_t(ior, device),
        ),
        mat_type=_t(mat, device, torch.int32),
        active=_t(active, device, torch.bool),
    )


def camera_config_from_numpy(arrays: Sequence[np.ndarray],
                             device="cpu") -> CameraConfig:
    """CameraConfig from the 12 leaves of a JAX ``CameraConfig``: vfov,
    lookfrom x/y/z, lookat x/y/z, vup x/y/z, defocus_angle, focus_dist.
    Host data by default, as ``CameraConfig.reference_default``: the
    renderers derive the camera row and move it to the scene's device."""
    if len(arrays) != 12:
        raise ValueError(f"a CameraConfig has 12 leaves, got {len(arrays)}")
    t = [_t(a, device) for a in arrays]
    return CameraConfig(
        vfov=t[0],
        lookfrom=Vec3(*t[1:4]),
        lookat=Vec3(*t[4:7]),
        vup=Vec3(*t[7:10]),
        defocus_angle=t[10],
        focus_dist=t[11],
    )


def camera_row_from_numpy(row: np.ndarray, device="cpu") -> torch.Tensor:
    """A packed (1, 24) f32 camera row (the JAX ``pack_camera`` layout),
    so both packages can be fed one identical derived camera. Host data
    by default: the kernel wrappers move the row to their lanes'
    device."""
    row = np.asarray(row, np.float32)
    if row.shape != (1, 24):
        raise ValueError(f"camera row must have shape (1, 24), got {row.shape}")
    return _t(row, device)


def f64_inputs_from_numpy(sm_hi, sm_lo, cam_rows, device=None) -> tuple:
    """The f64 render's scene and camera, on ``device`` (None: the card),
    from the JAX df64 inputs:
    ``pack_scene_matrix_df64``'s (N, 16) f32 (hi, lo) matrices and
    ``initialize_f64``'s (2, 24) hi/lo camera rows. Returns (scene_mat
    (N, 16) f32, cam_row (24,) float64), each the hi + lo of its pair in
    float64. The port's scene matrix is f32, so ``sm_lo`` must be 0 (it
    is for every scene the JAX package builds: its params are f32)."""
    device = resolve_device(device)
    hi = np.asarray(sm_hi, np.float32)
    lo = np.asarray(sm_lo, np.float32)
    rows = np.asarray(cam_rows, np.float32)
    if hi.shape != lo.shape or hi.ndim != 2 or hi.shape[1] != 16:
        raise ValueError(f"scene hi/lo must be two (N, 16) matrices, got "
                         f"{hi.shape} and {lo.shape}")
    if rows.shape != (2, 24):
        raise ValueError(f"camera rows must have shape (2, 24), got "
                         f"{rows.shape}")
    if lo.any():
        raise ValueError("the scene's lo words are not 0: the port's scene "
                         "matrix is f32")
    cam = rows[0].astype(np.float64) + rows[1].astype(np.float64)
    return _t(hi, device), _t(cam, device)


def train_state_from_numpy(arrays: Sequence[np.ndarray], trainable=None,
                           device=None):
    """The port's ``ops.grad.TrainState``, on ``device`` (None: the card),
    from the leaves of a JAX
    ``TrainState`` built by ``make_train_step`` with ``optax.adam``: the
    9 SceneParams leaves, optax's ``count``, ``mu`` and ``nu``, and
    ``step``. With a ``trainable`` mask (a SceneParams of bools, as the
    JAX step was given) optax keeps moments for the trainable leaves
    only; the frozen leaves' moments are zeros here, and stay so. The
    count stays on the host, as ``AdamState`` keeps it."""
    from ..ops.grad import AdamState, TrainState

    device = resolve_device(device)
    mask = ([True] * 9 if trainable is None
            else [bool(t) for t in param_leaves(trainable)])
    k = sum(mask)
    if len(arrays) != 9 + 1 + 2 * k + 1:
        raise ValueError(f"a TrainState with {k} trainable leaves has "
                         f"{12 + 2 * k - 1} leaves, got {len(arrays)}")
    params = [_t(a, device) for a in arrays[:9]]

    def moments(flat):
        it = iter(flat)
        return params_from_leaves([_t(next(it), device) if m
                                   else torch.zeros_like(p)
                                   for m, p in zip(mask, params)])

    return TrainState(
        params=params_from_leaves(params),
        opt_state=AdamState(_t(arrays[9], "cpu", torch.int32),
                            moments(arrays[10:10 + k]),
                            moments(arrays[10 + k:10 + 2 * k])),
        step=_t(arrays[-1], device, torch.int32),
    )


def stream_scene_from_numpy(scene_mat, bounds, block: int, perm,
                            device=None):
    """The port's ``StreamScene``, on ``device`` (None: the card), from a
    JAX ``StreamScene``'s arrays: the matrix's columns 0-15 (the JAX
    matrix pads its rows to 128 lanes), the (nb, 8) bounds, the block
    size and ``perm``."""
    from ..ops.stream_kernel import StreamScene

    device = resolve_device(device)
    mat = np.asarray(scene_mat, np.float32)
    if mat.ndim != 2 or mat.shape[1] < 16 or mat.shape[0] % block:
        raise ValueError(f"stream matrix {mat.shape} is not whole blocks of "
                         f"{block} rows with at least 16 columns")
    return StreamScene(_t(np.ascontiguousarray(mat[:, :16]), device),
                       _t(np.asarray(bounds, np.float32), device), int(block),
                       _t(np.asarray(perm), device, torch.int32))
