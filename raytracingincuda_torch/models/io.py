"""Scene asset import and export.

The counterpart of ``raytracingincuda_tpu/models/io.py``; the two
packages read each other's files. Two formats:

  .npz  binary SoA arrays (``center`` (N, 3), ``radius``, ``albedo``
        (N, 3), ``fuzz``, ``ior``, ``mat_type``, optionally ``active``);
        a 100k-sphere asset loads in milliseconds.
  .csv  a sphere list, one sphere a row:
        ``cx,cy,cz,radius,mat,albedo_r,albedo_g,albedo_b,fuzz,ior``, with
        ``#`` comments and blank lines ignored. ``mat`` takes the integer
        ids or the names lambertian / metal / dielectric (and the
        reference's spelling "dieletric").

``save_scene`` writes the active slots only; ``load_scene`` pads again
(to a multiple of 128 slots by default, as ``build_scene`` pads), so the
slot count, which picks the adaptive and stream routes (more than 4096
slots), is the JAX package's. Files are read and written as host numpy;
the scene is then made on ``device``, the card unless the caller passes
``device='cpu'``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .scene import DIELECTRIC, LAMBERTIAN, METAL, Scene, round_up, to_scene

_MAT_NAMES = {"lambertian": LAMBERTIAN, "metal": METAL,
              "dielectric": DIELECTRIC,
              # the reference's spelling (material.h: "dieletric" sic)
              "dieletric": DIELECTRIC}
_MAT_IDS = {LAMBERTIAN: "lambertian", METAL: "metal",
            DIELECTRIC: "dielectric"}


def scene_from_arrays(
    center: np.ndarray,          # (N, 3)
    radius: np.ndarray,          # (N,)
    mat_type: np.ndarray,        # (N,) int
    albedo: Optional[np.ndarray] = None,   # (N, 3)
    fuzz: Optional[np.ndarray] = None,     # (N,)
    ior: Optional[np.ndarray] = None,      # (N,)
    active: Optional[np.ndarray] = None,   # (N,) bool
    dtype=torch.float32,
    pad_to_multiple: Optional[int] = 128,
    device=None,
) -> Scene:
    """A padded Scene on ``device`` (None: the card) from host arrays (the
    programmatic import path; the file loaders call it)."""
    center = np.asarray(center, np.float64).reshape(-1, 3)
    n = center.shape[0]
    radius = np.asarray(radius, np.float64).reshape(n)
    mat_type = np.asarray(mat_type, np.int32).reshape(n)
    albedo = (np.zeros((n, 3)) if albedo is None
              else np.asarray(albedo, np.float64).reshape(n, 3))
    # the reference's metal constructor clamps fuzz at 1 (material.h), as
    # build_scene does
    fuzz = (np.zeros(n) if fuzz is None
            else np.minimum(np.asarray(fuzz, np.float64).reshape(n), 1.0))
    ior = (np.ones(n) if ior is None
           else np.asarray(ior, np.float64).reshape(n))
    active = (np.ones(n, bool) if active is None
              else np.asarray(active, bool).reshape(n))
    if not np.isin(mat_type, (LAMBERTIAN, METAL, DIELECTRIC)).all():
        raise ValueError("mat_type must be 0 (lambertian), 1 (metal) or "
                         "2 (dielectric)")
    if (radius == 0).any():
        raise ValueError(
            "radius must be nonzero (negative radii are allowed: they "
            "flip the normal inward, the hollow-glass trick)")
    if (ior <= 0).any():
        raise ValueError(
            "ior must be > 0 (a zero or negative index produces NaN "
            "refraction directions)")

    n_padded = (round_up(max(n, 1), pad_to_multiple) if pad_to_multiple
                else max(n, 1))
    pad = n_padded - n

    def padf(a, fill=0.0):
        if pad == 0:
            return a
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                          a.dtype)])

    center = padf(center)
    if pad:
        center[n:, 1] = -1.0e6     # parked placeholders, as build_scene's
    return to_scene(center, padf(radius, 1.0), padf(albedo), padf(fuzz),
                     padf(ior, 1.0), padf(mat_type), padf(active, False),
                     dtype, device)


def _scene_to_arrays(scene: Scene) -> dict:
    """The active slots' host arrays, in the ``.npz`` keys."""
    p = scene.params
    keep = np.flatnonzero(scene.active.cpu().numpy())   # drop the padding

    def host(t):
        return t.detach().cpu().numpy()[keep]

    return dict(
        center=np.stack([host(p.center.x), host(p.center.y),
                         host(p.center.z)], axis=1),
        radius=host(p.radius),
        albedo=np.stack([host(p.albedo.x), host(p.albedo.y),
                         host(p.albedo.z)], axis=1),
        fuzz=host(p.fuzz),
        ior=host(p.ior),
        mat_type=host(scene.mat_type),
    )


def save_scene(path: str, scene: Scene) -> None:
    """Write a scene to ``.npz`` or ``.csv`` by the extension (active slots
    only: the padding is made at load)."""
    ext = os.path.splitext(path)[1].lower()
    arrs = _scene_to_arrays(scene)
    if ext == ".npz":
        np.savez_compressed(path, **arrs)
    elif ext in (".csv", ".txt"):
        with open(path, "w") as f:
            f.write("# cx,cy,cz,radius,mat,albedo_r,albedo_g,albedo_b,"
                    "fuzz,ior\n")
            for i in range(arrs["center"].shape[0]):
                c = arrs["center"][i]
                a = arrs["albedo"][i]
                f.write(
                    f"{c[0]:.9g},{c[1]:.9g},{c[2]:.9g},"
                    f"{arrs['radius'][i]:.9g},"
                    f"{_MAT_IDS[int(arrs['mat_type'][i])]},"
                    f"{a[0]:.9g},{a[1]:.9g},{a[2]:.9g},"
                    f"{arrs['fuzz'][i]:.9g},{arrs['ior'][i]:.9g}\n")
    else:
        raise ValueError(f"unsupported scene format: {ext} "
                         "(use .npz or .csv)")


def load_scene(path: str, dtype=torch.float32,
               pad_to_multiple: Optional[int] = 128,
               device=None) -> Scene:
    """Load a scene asset (``.npz`` or ``.csv``) into a padded Scene on
    ``device`` (None: the card)."""
    ext = os.path.splitext(path)[1].lower()
    kw = dict(dtype=dtype, pad_to_multiple=pad_to_multiple, device=device)
    if ext == ".npz":
        with np.load(path) as z:
            return scene_from_arrays(
                z["center"], z["radius"], z["mat_type"],
                albedo=z.get("albedo"), fuzz=z.get("fuzz"), ior=z.get("ior"),
                active=z.get("active"), **kw)
    if ext in (".csv", ".txt"):
        rows = []
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                if len(parts) != 10:
                    raise ValueError(
                        f"{path}:{lineno}: expected 10 fields "
                        f"(cx,cy,cz,radius,mat,albedo_rgb,fuzz,ior), "
                        f"got {len(parts)}")
                mat = parts[4].lower()
                mat_id = _MAT_NAMES[mat] if mat in _MAT_NAMES else int(mat)
                rows.append([float(parts[0]), float(parts[1]),
                             float(parts[2]), float(parts[3]), mat_id,
                             float(parts[5]), float(parts[6]),
                             float(parts[7]), float(parts[8]),
                             float(parts[9])])
        if not rows:
            raise ValueError(f"{path}: no spheres")
        arr = np.asarray(rows, np.float64)
        return scene_from_arrays(
            arr[:, 0:3], arr[:, 3], arr[:, 4].astype(np.int32),
            albedo=arr[:, 5:8], fuzz=arr[:, 8], ior=arr[:, 9], **kw)
    raise ValueError(f"unsupported scene format: {ext} (use .npz or .csv)")
