"""The plain reference path tracer that judges the port's outputs.

Straight PyTorch, written from the estimator's definition: the reference
camera, a brute-force closest hit over every active sphere, the three
materials, the sky, parity or Russian roulette, each draw from
``sampler``. It traces any set of (pixel, sample) lanes on their own, so
a check traces a sample of an image's pixels at the image's own size,
samples and depth. Every expression keeps the association the estimator
fixes, so in float32 a lane's radiance is the same bits whatever traces
it; ``dtype=torch.bfloat16`` is the control, the step below float32.

``radiance`` returns per-pixel sums; with ``leaves`` given (the nine
parameter tensors, requiring grad) the sums are differentiable under the
detached-sampler convention: the draws and every discrete decision (the
winning sphere, the material, the coins, absorption, the roulette kill)
are constants, and the gradient flows through the winner's distance and
the continuous quantities it selects.

It imports nothing of the port and takes none of its outputs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import sampler
from .vec import (Vec3, clip, cross, dot, full, maximum, minimum, near_zero,
                  reflect, refract, unit, where)

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
T_MISS = 1.0e30
T_MIN = 1.0e-3
SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)
LEAVES = ("cx", "cy", "cz", "radius", "ar", "ag", "ab", "fuzz", "ior")
# The most (sphere, lane) pairs one scan holds at once.
_SCAN_ELEMS = 1 << 26


class Camera(NamedTuple):
    center: Vec3
    pixel00: Vec3
    du: Vec3
    dv: Vec3
    disk_u: Vec3
    disk_v: Vec3
    use_defocus: torch.Tensor


def camera(cfg: dict, width: int, height: int, device, dtype=torch.float32):
    """The reference viewport, derived in float32 on the host (the
    estimator fixes these bits) and moved to ``device`` in ``dtype``."""
    def s(v):
        return torch.tensor(float(v), dtype=torch.float32)

    def v3(t):
        return Vec3(*(s(c) for c in t))

    lookfrom, lookat, vup = v3(cfg["lookfrom"]), v3(cfg["lookat"]), v3(cfg["vup"])
    focus, vfov = s(cfg["focus_dist"]), s(cfg["vfov"])
    theta = vfov * (math.pi / 180.0)
    h = torch.tan(theta / 2.0)
    vp_h = 2.0 * h * focus
    vp_w = vp_h * (float(width) / float(height))
    w = unit(lookfrom - lookat)
    u = unit(cross(vup, w))
    v = cross(w, u)
    vu = u * vp_w
    vv = (-v) * vp_h
    du = vu / float(width)
    dv = vv / float(height)
    upper_left = lookfrom - w * focus - vu / 2.0 - vv / 2.0
    pixel00 = upper_left + (du + dv) * 0.5
    radius = focus * torch.tan((s(cfg["defocus_angle"]) / 2.0)
                               * (math.pi / 180.0))
    move = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
    return Camera(lookfrom.map(move), pixel00.map(move), du.map(move),
                  dv.map(move), (u * radius).map(move),
                  (v * radius).map(move),
                  (s(cfg["defocus_angle"]) > 0.0).to(device))


def primary(cam: Camera, fi, fj, pix, sample, key, dtype):
    """Jittered, defocused camera rays of lanes at column ``fi``, row
    ``fj`` (floats) of pixel ids ``pix``, sample ids ``sample``."""
    u0, u1 = sampler.uniform2(key, pix, sample, 0, sampler.DRAW_JITTER, dtype)
    px, py = sampler.in_unit_disk(key, pix, sample, dtype)
    target = cam.pixel00 + cam.du * (fi + (u0 - 0.5)) + cam.dv * (fj + (u1 - 0.5))
    blurred = cam.center + cam.disk_u * px + cam.disk_v * py
    center = cam.center.map(lambda c: c.expand(pix.shape))
    origin = where(cam.use_defocus, blurred, center)
    return origin, target - origin


def sky(d: Vec3) -> Vec3:
    ud = unit(d)
    a = 0.5 * (ud.y + 1.0)
    kw = dict(dtype=a.dtype, device=a.device)
    return (full(a.shape, SKY_WHITE, **kw) * (1.0 - a)
            + full(a.shape, SKY_BLUE, **kw) * a)


def gamma2(x):
    """sqrt of positive values, 0 at and below black."""
    pos = x > 0.0
    return torch.where(pos, sampler.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def _roots(cx, cy, cz, r, o: Vec3, d: Vec3, tmin):
    """The half-b quadratic's root numerator over broadcast spheres and
    rays, and whether it is a valid hit (the near root unless it lies
    below ``tmin * a``)."""
    a = maximum(d.x * d.x + d.y * d.y + d.z * d.z, 1e-12)
    h = (cx * d.x + cy * d.y + cz * d.z) - (d.x * o.x + d.y * o.y + d.z * o.z)
    c2r2 = cx * cx + cy * cy + cz * cz - r * r
    c = (c2r2 + (o.x * o.x + o.y * o.y + o.z * o.z)) - 2.0 * (
        cx * o.x + cy * o.y + cz * o.z)
    disc = h * h - a * c
    pos = disc > 0.0
    sq = sampler.sqrt(torch.where(pos, disc, torch.ones_like(disc)))
    tmin_a = tmin * a
    near = h - sq
    root = torch.where(near > tmin_a, near, h + sq)
    return root, pos & (root > tmin_a), a


def closest(sc: dict, o: Vec3, d: Vec3):
    """(hit, winning slot) of each ray over every active slot; the
    smallest root numerator wins, the lowest slot at a tie."""
    ids = sc["scan_ids"]
    cx, cy, cz, r = (sc[k].detach()[ids][:, None]
                     for k in ("cx", "cy", "cz", "radius"))
    lanes = o.x.shape[0]
    step = max(1, _SCAN_ELEMS // max(1, ids.shape[0]))
    hit = torch.zeros(lanes, dtype=torch.bool, device=o.x.device)
    win = torch.zeros(lanes, dtype=torch.int64, device=o.x.device)
    with torch.no_grad():
        # the scan's dtype is the traced dtype (the control's scan too)
        cx, cy, cz, r = (t.to(o.x.dtype) for t in (cx, cy, cz, r))
        for lo in range(0, lanes, step):
            sl = slice(lo, lo + step)
            oo = Vec3(*(t.detach()[sl][None, :] for t in o))
            dd = Vec3(*(t.detach()[sl][None, :] for t in d))
            root, valid, _ = _roots(cx, cy, cz, r, oo, dd, T_MIN)
            t_num, k = torch.min(torch.where(valid, root,
                                             torch.full_like(root, T_MISS)), 0)
            hit[sl] = t_num < T_MISS
            win[sl] = ids[k]
    return hit, win


def radiance(sc: dict, cam: Camera, seed: int, pix, width: int, samples: int,
             depth: int, *, rr_start=None, dtype=torch.float32,
             sample_offset: int = 0):
    """Per-pixel radiance sums (3, len(pix)) of samples [offset, offset +
    samples), added in sample order, and the needed-work counts of the
    traced segments (``work.COUNT_KEYS``). ``sc``: the scene's slot tensors
    (``scene_tensors``), differentiable where they require grad."""
    key = sampler.key_from_seed(seed)
    dev = pix.device
    n_pix = pix.shape[0]
    lane_pix = pix.repeat(samples)
    lane_s = torch.arange(sample_offset, sample_offset + samples, device=dev
                          ).repeat_interleave(n_pix)
    fi = (lane_pix % width).to(dtype)
    fj = torch.div(lane_pix, width, rounding_mode="floor").to(dtype)
    o, d = primary(cam, fi, fj, lane_pix, lane_s, key, dtype)
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
        hit[live], win[live] = closest(
            sc, o.map(lambda t: t[live]), d.map(lambda t: t[live]))
        g = {k: sc[k][win].to(dtype) for k in LEAVES}
        center = Vec3(g["cx"], g["cy"], g["cz"])
        root, _, a = _roots(center.x, center.y, center.z, g["radius"], o, d,
                            T_MIN)
        t = torch.where(hit, root * (1.0 / a), torch.ones_like(root))
        p = o + d * t
        rs = torch.where(g["radius"].abs() > 1e-12, g["radius"],
                         torch.full_like(g["radius"], 1e-12))
        outward = (p - center) / rs
        front = dot(d, outward) < 0.0
        normal = where(front, outward, -outward)
        ur = Vec3(*sampler.unit_vector(key, lane_pix, lane_s, b, dtype))
        coin, _ = sampler.uniform2(key, lane_pix, lane_s, b,
                                   sampler.DRAW_COIN, dtype)
        direction, att, scattered = _scatter(
            d, normal, front, sc["mat"][win], Vec3(g["ar"], g["ag"], g["ab"]),
            g["fuzz"], g["ior"], ur, coin)
        miss = alive & ~hit
        rad = rad + where(miss, atten * sky(d), zero)
        go = alive & hit & scattered
        counts["hits"] += int((alive & hit).sum())
        counts["misses"] += int(miss.sum())
        upd = atten * att
        if rr_start is not None and b >= rr_start:
            counts["rr_draws"] += int((go & (b < depth - 1)).sum())
            ps = clip(torch.maximum(torch.maximum(upd.x, upd.y), upd.z),
                      0.05, 1.0)
            u_rr, _ = sampler.uniform2(key, lane_pix, lane_s, b,
                                       sampler.DRAW_RR, dtype)
            go = go & ~(u_rr >= ps)
            upd = upd * (1.0 / ps)
        o = where(go, p, o)
        d = where(go, direction, d)
        atten = where(go, upd, atten)
        alive = go
    acc = None
    for s in range(samples):
        sl = slice(s * n_pix, (s + 1) * n_pix)
        part = torch.stack([rad.x[sl], rad.y[sl], rad.z[sl]])
        acc = part if acc is None else acc + part
    return acc, counts


def _scatter(d_in: Vec3, normal: Vec3, front, mat, albedo: Vec3, fuzz, ior,
             ur: Vec3, coin):
    """Every material's scatter, selected by ``mat``."""
    one = torch.ones_like(fuzz)
    lam = normal + ur
    lam = where(near_zero(lam), normal, lam)
    metal = unit(reflect(d_in, normal)) + ur * fuzz
    metal_ok = dot(metal, normal) > 0.0
    ri = torch.where(front, 1.0 / ior, ior)
    ud = unit(d_in)
    cos_t = minimum(dot(-ud, normal), 1.0)
    sin_t = sampler.sqrt(maximum(1.0 - cos_t * cos_t, 0.0))
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    x = 1.0 - cos_t
    x2 = x * x
    schlick = r0 + (1.0 - r0) * (x * (x2 * x2))
    diel = where((ri * sin_t > 1.0) | (schlick > coin), reflect(ud, normal),
                 refract(ud, normal, ri))
    is_lam, is_metal = mat == LAMBERTIAN, mat == METAL
    direction = where(is_lam, lam, where(is_metal, metal, diel))
    att = where(mat == DIELECTRIC, Vec3(one, one, one), albedo)
    return direction, att, metal_ok | ~is_metal


def scene_tensors(arrays: dict, device, dtype=torch.float32,
                  requires_grad: bool = False) -> dict:
    """The slot tensors the tracer reads, from a scene's arrays (the nine
    leaves, ``mat`` and ``active``): the leaves in ``dtype`` (leaf
    tensors when ``requires_grad``), and the ids of the active slots,
    the only ones the scan tests."""
    sc = {}
    for k in LEAVES:
        t = torch.as_tensor(arrays[k]).detach().to(device=device, dtype=dtype)
        sc[k] = t.clone().requires_grad_(True) if requires_grad else t
    sc["mat"] = torch.as_tensor(arrays["mat"]).to(device=device,
                                                  dtype=torch.int32)
    active = torch.as_tensor(arrays["active"]).to(device=device,
                                                  dtype=torch.bool)
    sc["scan_ids"] = torch.nonzero(active).reshape(-1)
    return sc
