"""The plain reference of the double-precision render (the df64 contract).

Straight PyTorch, written from the contract that ``rtow_cover_f64``
states: the camera row, the geometry, the attenuation, the sky and the
sums are double; the random draws are the f32 values of ``sampler``,
promoted exactly (the jitter, the defocus disk, the unit vector and the
coin). The scope is the parity estimator and the current-bounce sky. A
brute-force closest hit tests every active slot and keeps the smallest
root numerator, the lowest slot at an exact tie. Every expression keeps
the contract's association, which is not ``tracer.py``'s:

- the sample position ``fi + (u0 - 0.5)`` in double;
- ``t = t_num / a``, a division;
- dot products left to right, ``c = (c2r2 + |O|^2) - 2 C.O``;
- Schlick's ``(1 - cos)^5`` as ``(om2 * om2) * om``;
- ``unit(v) = v * (1 / sqrt(max(|v|^2, 1e-30)))``;
- the finish, ``1 / spp`` and then gamma 2, in double.

Double ``+ - * /`` and ``sqrt`` are correctly rounded, so a lane's sums
are the same bits whatever traces it: ``sqrt`` is numpy's on the CPU
(torch's vectorized one is an ulp off on some inputs there) and torch's on
a card. ``dtype=torch.float32`` is the control, the precision below the
contract's: the same expressions, camera and scene rounded to float32.

It imports nothing of the port and takes none of its outputs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import sampler
from .tracer import DIELECTRIC, LAMBERTIAN, LEAVES, METAL, T_MIN, T_MISS
from .vec import Vec3, dot, full, maximum, minimum, near_zero, reflect, where

# The most (slot, lane) pairs one scan holds at once.
_SCAN_ELEMS = 1 << 24


class Camera(NamedTuple):
    pixel00: Vec3
    du: Vec3
    dv: Vec3
    center: Vec3
    disk_u: Vec3
    disk_v: Vec3
    defocus: bool


def camera(cfg: dict, width: int, height: int, device,
           dtype=torch.float64) -> Camera:
    """The viewport derived in double on the host from the configuration's
    numbers as f32 scalars (how a user hands them to the renderer), moved
    to ``device`` in ``dtype``."""
    f = sampler.f32
    v3 = lambda c: np.array([f(x) for x in c], np.float64)  # noqa: E731
    lookfrom, lookat = v3(cfg["lookfrom"]), v3(cfg["lookat"])
    vup = v3(cfg["vup"])
    theta = f(cfg["vfov"]) * (math.pi / 180.0)
    h = np.tan(theta / 2.0)
    focus = f(cfg["focus_dist"])
    vp_h = 2.0 * h * focus
    vp_w = vp_h * (float(width) / float(height))

    def unit(v):
        return v / np.sqrt((v * v).sum())

    w = unit(lookfrom - lookat)
    u = unit(np.cross(vup, w))
    v = np.cross(w, u)
    vu = u * vp_w
    vv = -v * vp_h
    du = vu / float(width)
    dv = vv / float(height)
    upper_left = lookfrom - w * focus - vu / 2.0 - vv / 2.0
    radius = focus * np.tan((f(cfg["defocus_angle"]) / 2.0)
                            * (math.pi / 180.0))

    def move(x):
        return Vec3(*(torch.tensor(float(c), dtype=dtype, device=device)
                      for c in x))

    return Camera(move(upper_left + (du + dv) * 0.5), move(du), move(dv),
                  move(lookfrom), move(u * radius), move(v * radius),
                  f(cfg["defocus_angle"]) > 0.0)


def _sqrt(x):
    """The correctly rounded sqrt in ``x``'s dtype."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _unit(v: Vec3) -> Vec3:
    return v * (1.0 / _sqrt(maximum(dot(v, v), 1e-30)))


def _sky(d: Vec3) -> Vec3:
    """(1 - a) white + a blue, a = 0.5 (unit(d).y + 1)."""
    uy = d.y * (1.0 / _sqrt(maximum(dot(d, d), 1e-30)))
    a = 0.5 * (uy + 1.0)
    w = 1.0 - a
    return Vec3(w * 1.0 + a * 0.5, w * 1.0 + a * 0.7, w * 1.0 + a * 1.0)


def _closest(sc: dict, o: Vec3, d: Vec3):
    """(hit, winning slot, t = t_num / a) of each ray over every active
    slot: the smallest root numerator wins, the lowest slot at a tie."""
    ids = sc["scan_ids"]
    cx, cy, cz, r = (sc[k][ids][:, None] for k in ("cx", "cy", "cz", "radius"))
    c2r2 = ((cx * cx + cy * cy) + cz * cz) - r * r
    lanes = o.x.shape[0]
    step = max(1, _SCAN_ELEMS // max(1, ids.shape[0]))
    hit = torch.zeros(lanes, dtype=torch.bool, device=o.x.device)
    win = torch.zeros(lanes, dtype=torch.int64, device=o.x.device)
    t = torch.ones(lanes, dtype=o.x.dtype, device=o.x.device)
    for lo in range(0, lanes, step):
        sl = slice(lo, lo + step)
        oo = Vec3(*(c[sl][None, :] for c in o))
        dd = Vec3(*(c[sl][None, :] for c in d))
        a = maximum(dot(dd, dd), 1e-12)
        h = ((cx * dd.x + cy * dd.y) + cz * dd.z) - dot(dd, oo)
        c = (c2r2 + dot(oo, oo)) - 2.0 * ((cx * oo.x + cy * oo.y) + cz * oo.z)
        disc = h * h - a * c
        pos = disc > 0.0
        sq = _sqrt(torch.where(pos, disc, torch.ones_like(disc)))
        tmin_a = T_MIN * a
        near = h - sq
        root = torch.where(near > tmin_a, near, h + sq)
        valid = pos & (root > tmin_a)
        t_num, k = torch.min(torch.where(valid, root,
                                         torch.full_like(root, T_MISS)), 0)
        hit[sl] = t_num < T_MISS
        win[sl] = ids[k]
        t[sl] = torch.where(hit[sl], t_num / a[0], t[sl])
    return hit, win, t


def _primary(cam: Camera, fi, fj, pix, sample, key, dtype):
    """Camera rays: f32 jitter and disk draws, geometry in ``dtype``."""
    f32 = torch.float32
    u0, u1 = sampler.uniform2(key, pix, sample, 0, sampler.DRAW_JITTER, f32)
    px, py = sampler.in_unit_disk(key, pix, sample, f32)
    ix = fi + (u0 - 0.5).to(dtype)
    jy = fj + (u1 - 0.5).to(dtype)
    target = (cam.pixel00 + cam.du * ix) + cam.dv * jy
    if cam.defocus:
        origin = ((cam.center + cam.disk_u * px.to(dtype))
                  + cam.disk_v * py.to(dtype))
    else:
        origin = cam.center.map(lambda c: c.expand(pix.shape))
    return origin, target - origin


def _scatter(d: Vec3, normal: Vec3, front, mat, albedo: Vec3, fuzz, ior,
             ur: Vec3, coin):
    """Every material's scatter, selected by ``mat``: (direction,
    attenuation, scattered)."""
    lam = normal + ur
    lam = where(near_zero(lam), normal, lam)
    metal = _unit(reflect(d, normal)) + ur * fuzz
    metal_ok = dot(metal, normal) > 0.0
    ri = torch.where(front, 1.0 / ior, ior)
    ud = _unit(d)
    cos_t = minimum(dot(-ud, normal), 1.0)
    sin_t = _sqrt(maximum(1.0 - cos_t * cos_t, 0.0))
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    om = 1.0 - cos_t
    om2 = om * om
    coin_reflects = r0 + (1.0 - r0) * ((om2 * om2) * om) > coin
    perp = (ud + normal * cos_t) * ri
    par = _sqrt(maximum((1.0 - dot(perp, perp)).abs(), 1e-12))
    diel = where((ri * sin_t > 1.0) | coin_reflects, reflect(ud, normal),
                 perp + normal * (-par))
    is_metal = mat == METAL
    direction = where(mat == LAMBERTIAN, lam, where(is_metal, metal, diel))
    one = torch.ones_like(fuzz)
    att = where(mat == DIELECTRIC, Vec3(one, one, one), albedo)
    return direction, att, metal_ok | ~is_metal


def radiance(sc: dict, cam: Camera, seed: int, pix, width: int, samples: int,
             depth: int, *, dtype=torch.float64):
    """Per-pixel radiance sums (3, len(pix)) in ``dtype`` of samples [0,
    samples), added in sample order, and the needed-work counts of the
    traced segments (``work.COUNT_KEYS``). ``sc``: ``tracer.scene_tensors``
    of the scene in ``dtype``; ``cam``: ``camera`` in ``dtype``."""
    f32 = torch.float32
    key = sampler.key_from_seed(seed)
    dev = pix.device
    n_pix = pix.shape[0]
    lane_pix = pix.repeat(samples)
    lane_s = torch.arange(samples, device=dev).repeat_interleave(n_pix)
    fi = (lane_pix % width).to(dtype)
    fj = torch.div(lane_pix, width, rounding_mode="floor").to(dtype)
    o, d = _primary(cam, fi, fj, lane_pix, lane_s, key, dtype)
    lanes = lane_pix.shape[0]
    atten = full(lanes, (1.0, 1.0, 1.0), dtype, dev)
    zero = full(lanes, (0.0, 0.0, 0.0), dtype, dev)
    rad = zero
    alive = torch.ones(lanes, dtype=torch.bool, device=dev)
    counts = dict(samples=lanes, hits=0, misses=0, rr_draws=0)
    for b in range(depth):
        if not bool(alive.any()):
            break
        live = torch.nonzero(alive).reshape(-1)
        hit = torch.zeros(lanes, dtype=torch.bool, device=dev)
        win = sc["scan_ids"][:1].repeat(lanes)
        t = torch.ones(lanes, dtype=dtype, device=dev)
        hit[live], win[live], t[live] = _closest(
            sc, o.map(lambda c: c[live]), d.map(lambda c: c[live]))
        g = {k: sc[k][win] for k in LEAVES}
        p = o + d * t
        rs = torch.where(g["radius"].abs() > 1e-12, g["radius"],
                         torch.full_like(g["radius"], 1e-12))
        outward = (p - Vec3(g["cx"], g["cy"], g["cz"])) * (1.0 / rs)
        front = dot(d, outward) < 0.0
        normal = where(front, outward, -outward)
        ur = sampler.unit_vector(key, lane_pix, lane_s, b, f32)
        coin, _ = sampler.uniform2(key, lane_pix, lane_s, b,
                                   sampler.DRAW_COIN, f32)
        direction, att, scattered = _scatter(
            d, normal, front, sc["mat"][win], Vec3(g["ar"], g["ag"], g["ab"]),
            g["fuzz"], g["ior"], Vec3(*(c.to(dtype) for c in ur)),
            coin.to(dtype))
        miss = alive & ~hit
        rad = rad + where(miss, atten * _sky(d), zero)
        counts["hits"] += int((alive & hit).sum())
        counts["misses"] += int(miss.sum())
        go = alive & hit & scattered & (b < depth - 1)
        o = where(go, p, o)
        d = where(go, direction, d)
        atten = where(go, atten * att, atten)
        alive = go
    acc = None
    for s in range(samples):
        sl = slice(s * n_pix, (s + 1) * n_pix)
        part = torch.stack([rad.x[sl], rad.y[sl], rad.z[sl]])
        acc = part if acc is None else acc + part
    return acc, counts


def finish(acc, samples: int):
    """The image from the sums: ``1 / spp``, then gamma 2 (the square root
    of positive values, 0 at and below black), in the sums' dtype."""
    img = acc * (1.0 / samples)
    pos = img > 0.0
    return torch.where(pos, _sqrt(torch.where(pos, img, torch.ones_like(img))),
                       torch.zeros_like(img))
