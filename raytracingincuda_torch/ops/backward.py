"""The reverse pass of one bounce, written out by hand.

The counterpart of the helpers of ``raytracingincuda_tpu/ops/pallas_backward.py``
(``_camera_from_scalars`` :231, ``_hit_winner`` :246, ``_bounce_draws``
:267, ``_winner_bounce`` :289). The JAX kernels differentiate
``_winner_bounce`` with ``jax.vjp`` inside the kernel; here its adjoint is
explicit formulas (``winner_bounce_vjp``), because the CUDA kernel
(``csrc/train_render.cu``) repeats them line for line and the CPU tests
hold them to ``jax.vjp`` first.

Gradient convention: the detached sampler (``ops/grad.py``). The random
draws, the hit winner, the material, the Schlick coin, the near-zero
fallback, metal absorption, the Russian-roulette kill, the depth cap and
liveness are constants; gradients flow through the winner's root, the hit
point and normal, the scattered direction, the attenuation products, the
sky blend and the RR weight ``1/p_surv``. Ties follow JAX: ``maximum``,
``minimum`` and ``clip`` pass half the gradient to each side at a tie,
``abs'(0) = 0``, and a ``where`` passes the cotangent only to the branch
it selects.

Lanes are a flat batch of R rays; every function takes and returns
tensors of shape (R,) (``Vec3`` for 3-vectors).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import materials
from ..models.camera import Camera
from ..models.scene import DIELECTRIC, LAMBERTIAN, METAL
from . import f32math
from . import rng as rtrng
from . import vec
from .intersect import T_MIN, hit_world
from .tracer import SKY_BLUE, SKY_WHITE, _sky_color
from .vec import Vec3

# differentiable camera scalars: pack_camera columns 0..17
N_CAM = 18


def camera_from_scalars(vals, use_defocus) -> Camera:
    """Camera from 18 scalars (pack_camera columns 0..17); the defocus
    flag is passed separately (detached)."""
    v3 = lambda k: Vec3(vals[k], vals[k + 1], vals[k + 2])  # noqa: E731
    return Camera(
        pixel00_loc=v3(0),
        pixel_delta_u=v3(3),
        pixel_delta_v=v3(6),
        center=v3(9),
        defocus_disk_u=v3(12),
        defocus_disk_v=v3(15),
        use_defocus=use_defocus,
    )


class Winner(NamedTuple):
    """The winning slot's parameters per lane (zeros on a miss, as the
    JAX one-hot gather gives) and its slot id."""
    hit: torch.Tensor       # bool
    center: Vec3
    radius: torch.Tensor
    albedo: Vec3
    fuzz: torch.Tensor
    ior: torch.Tensor
    mat: torch.Tensor       # int32
    sid: torch.Tensor       # int64 slot id (meaningless on a miss)


def hit_winner(scene, o: Vec3, d: Vec3, closest=None) -> Winner:
    """Full, detached closest-hit scan; the reverse replays the winner
    only (``winner_bounce``). ``closest``: a precomputed ``HitResult``
    over ``scene``'s slots (the stream walk's); by default
    ``hit_world``'s."""
    hit, _t, idx = hit_world(scene, o, d) if closest is None else closest
    p = scene.params

    def take(col):
        return torch.where(hit, col[idx], torch.zeros_like(col[idx]))

    return Winner(
        hit=hit,
        center=Vec3(take(p.center.x), take(p.center.y), take(p.center.z)),
        radius=take(p.radius),
        albedo=Vec3(take(p.albedo.x), take(p.albedo.y), take(p.albedo.z)),
        fuzz=take(p.fuzz),
        ior=take(p.ior),
        mat=torch.where(hit, scene.mat_type[idx],
                        torch.zeros_like(scene.mat_type[idx])),
        sid=idx,
    )


def bounce_draws(pixel_ids, sample, bounce, key, rr: bool):
    """The per-bounce detached draws: scatter unit vector, coin, RR coin
    (zeros when RR is off), from the same streams as the forward."""
    unit_rand = rtrng.random_unit_vector(key, pixel_ids, sample, bounce,
                                         rtrng.DRAW_SCATTER)
    coin_u, _ = rtrng.uniform2(key, pixel_ids, sample, bounce, rtrng.DRAW_COIN)
    if rr:
        u_rr, _ = rtrng.uniform2(key, pixel_ids, sample, bounce, rtrng.DRAW_RR)
    else:
        u_rr = torch.zeros_like(coin_u)
    return unit_rand, coin_u, u_rr


def _max3(v: Vec3) -> torch.Tensor:
    return torch.maximum(torch.maximum(v.x, v.y), v.z)


class _Primal(NamedTuple):
    """A bounce's forward intermediates, shared by ``winner_bounce`` and
    its adjoint."""
    dd: torch.Tensor        # |d|^2
    a: torch.Tensor         # max(|d|^2, 1e-12)
    h: torch.Tensor
    c: torch.Tensor
    disc: torch.Tensor
    sqrtd: torch.Tensor
    take_near: torch.Tensor
    root: torch.Tensor
    t: torch.Tensor
    ior: torch.Tensor       # the winner's ior, 1 on a miss
    p: Vec3                 # hit point
    big: torch.Tensor       # |radius| > 1e-12
    rs: torch.Tensor        # safe signed radius
    diff: Vec3              # p - centre
    front: torch.Tensor
    normal: Vec3
    sc: materials.ScatterResult
    sky: Vec3
    miss: torch.Tensor      # a live lane that hit nothing
    survives: torch.Tensor  # a live lane that scatters on
    m: Vec3                 # atten * the material's attenuation
    zone: torch.Tensor      # RR applies at this bounce
    mx: torch.Tensor        # max channel of m
    p_surv: torch.Tensor    # clip(mx, 0.05, 1)
    atten_upd: Vec3         # m, weighted by 1/p_surv in the RR zone


def _bounce_primal(wc, wr, walb, wfuzz, wior, wmat, hit, o, d, atten, alive,
                   bounce, rr_start, draws) -> _Primal:
    unit_rand, coin_u, u_rr = draws
    one = torch.ones_like(wr)
    dd = vec.length_sq(d)
    a = vec.maximum(dd, 1e-12)
    h = vec.dot(wc, d) - vec.dot(d, o)
    c2r2 = vec.length_sq(wc) - wr * wr
    c = (c2r2 + vec.length_sq(o)) - 2.0 * vec.dot(wc, o)
    disc = h * h - a * c
    sqrtd = f32math.sqrt(torch.where(disc > 0.0, disc, one))
    near = h - sqrtd
    take_near = near > T_MIN * a
    root = torch.where(take_near, near, h + sqrtd)
    t = root * (1.0 / a)

    # miss lanes carry zero parameters (radius 0, ior 0): keep their
    # primals finite so no 0 * inf reaches a reverse pass
    wr_safe = torch.where(hit, wr, one)
    ior = torch.where(hit, wior, one)
    p = o + d * torch.where(hit, t, one)
    big = wr_safe.abs() > 1e-12
    rs = vec.safe_radius(wr_safe)
    diff = p - wc
    outward = diff / rs
    front = vec.dot(d, outward) < 0.0
    normal = vec.where(front, outward, -outward)
    sc = materials.scatter(d, normal, front, wmat, walb, wfuzz, ior,
                           unit_rand, coin_u)

    survives = alive & hit & sc.scattered
    m = atten * sc.attenuation
    mx = _max3(m)
    p_surv = vec.clip(mx, 0.05, 1.0)
    zone = (torch.zeros_like(hit) if rr_start is None
            else _in_rr_zone(bounce, rr_start, wr))
    atten_upd = m
    if rr_start is not None:
        survives = survives & ~(zone & (u_rr >= p_surv))
        atten_upd = m * torch.where(zone, 1.0 / p_surv, one)
    return _Primal(dd, a, h, c, disc, sqrtd, take_near, root, t, ior, p, big,
                   rs, diff, front, normal, sc, _sky_color(d), alive & ~hit,
                   survives, m, zone, mx, p_surv, atten_upd)


def winner_bounce(wc: Vec3, wr, walb: Vec3, wfuzz, wior, wmat, hit,
                  o: Vec3, d: Vec3, atten: Vec3, alive,
                  pixel_ids=None, sample=None, bounce=0, key=None,
                  rr_start=None, draws=None):
    """One bounce restricted to the stored winner sphere.

    ``hit``/``alive`` are bool, ``wmat`` int; ``bounce`` is the bounce
    index (int or int tensor). ``draws`` = (unit_rand, coin_u, u_rr), or
    None to draw them from (pixel_ids, sample, bounce, key). The winner's
    root is recomputed from its quadratic with the association of the
    full scan, so the primal equals the forward's bit for bit. Returns
    ((o', d', atten', alive'), contrib), contrib being the radiance this
    bounce banks (atten * sky on a live miss)."""
    if draws is None:
        draws = bounce_draws(pixel_ids, sample, bounce, key,
                             rr_start is not None)
    pr = _bounce_primal(wc, wr, walb, wfuzz, wior, wmat, hit, o, d, atten,
                        alive, bounce, rr_start, draws)
    zero3 = Vec3.zeros(wr.shape, device=wr.device)
    contrib = vec.where(pr.miss, atten * pr.sky, zero3)
    live = pr.survives
    out = (vec.where(live, pr.p, o), vec.where(live, pr.sc.direction, d),
           vec.where(live, pr.atten_upd, atten), live)
    return out, contrib


def _in_rr_zone(bounce, rr_start, like) -> torch.Tensor:
    z = torch.as_tensor(bounce, device=like.device) >= int(rr_start)
    return z.expand(like.shape)


def _dmax(x, lo):
    """d max(x, lo)/dx with JAX's tie rule (``lo`` a float or a tensor)."""
    return torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))


def _dmin(x, hi):
    """d min(x, hi)/dx with JAX's tie rule."""
    return torch.where(x < hi, 1.0, torch.where(x == hi, 0.5, 0.0))


def unit_vjp(v: Vec3, ct: Vec3, eps: float = 1e-30) -> Vec3:
    """Adjoint of ``vec.unit``: u = v * r, r = rsqrt(max(|v|^2, eps));
    dr/dq = -0.5 r / q (JAX's rsqrt rule)."""
    s = vec.length_sq(v)
    q = vec.maximum(s, eps)
    r = f32math.rsqrt(q)
    ct_s = vec.dot(ct, v) * (-0.5 * (r / q)) * _dmax(s, eps)
    return ct * r + v * (2.0 * ct_s)


def reflect_vjp(v: Vec3, n: Vec3, ct: Vec3):
    """Adjoint of r = v - n * (2 v.n): (ct_v, ct_n)."""
    cn = vec.dot(ct, n)
    ct_v = ct - n * (2.0 * cn)
    ct_n = (ct * (-2.0 * vec.dot(v, n))) - v * (2.0 * cn)
    return ct_v, ct_n


def sky_vjp(d: Vec3, ct_sky: Vec3) -> Vec3:
    """Adjoint of ``_sky_color(d)`` = lerp(0.5 (unit(d).y + 1), white,
    blue) with respect to d."""
    ct_a = vec.dot(ct_sky, Vec3(*(b - w for b, w in zip(SKY_BLUE, SKY_WHITE))))
    zero = torch.zeros_like(ct_a)
    return unit_vjp(d, Vec3(zero, 0.5 * ct_a, zero))


def refract_vjp(uv: Vec3, n: Vec3, ri, ct: Vec3):
    """Adjoint of ``vec.refract(uv, n, ri)``: (ct_uv, ct_n, ct_ri)."""
    x = vec.dot(-uv, n)
    cos = vec.minimum(x, 1.0)
    base = uv + n * cos
    perp = base * ri
    ell = vec.length_sq(perp)
    u = 1.0 - ell
    amag = u.abs()
    par = f32math.sqrt(vec.maximum(amag, 1e-12))
    # dir = perp + n * (-par)
    ct_perp = ct
    ct_n = ct * (-par)
    ct_par = -vec.dot(ct, n)
    ct_q = ct_par * (0.5 / par)
    ct_u = ct_q * _dmax(amag, 1e-12) * torch.sign(u)
    ct_perp = ct_perp + perp * (2.0 * -ct_u)
    # perp = (uv + n cos) * ri
    ct_ri = vec.dot(ct_perp, base)
    ct_base = ct_perp * ri
    ct_uv = ct_base
    ct_n = ct_n + ct_base * cos
    ct_x = vec.dot(ct_base, n) * _dmin(x, 1.0)
    ct_uv = ct_uv - n * ct_x
    ct_n = ct_n - uv * ct_x
    return ct_uv, ct_n, ct_ri


class BounceCotangents(NamedTuple):
    wc: Vec3
    wr: torch.Tensor
    walb: Vec3
    wfuzz: torch.Tensor
    wior: torch.Tensor
    o: Vec3
    d: Vec3
    atten: Vec3


def winner_bounce_vjp(wc: Vec3, wr, walb: Vec3, wfuzz, wior, wmat, hit,
                      o: Vec3, d: Vec3, atten: Vec3, alive,
                      ct_o: Vec3, ct_d: Vec3, ct_at: Vec3, g: Vec3, *,
                      bounce=0, rr_start=None, draws) -> BounceCotangents:
    """The adjoint of ``winner_bounce``, with no autograd.

    (ct_o, ct_d, ct_at) are the cotangents of the outgoing state and
    ``g`` that of ``contrib``; the cotangent of the outgoing liveness
    has no effect (liveness is detached), and so the result holds none.
    Per lane: a lane that does not scatter on (dead, miss, absorbed,
    killed by RR) passes (ct_o, ct_d, ct_at) through; a live miss adds
    g * sky to the attenuation's cotangent and the sky's adjoint to the
    direction's; a surviving scatter chains through the RR weight, the
    attenuation product, the material's direction, the normal, the hit
    point and the winner's root into the winner and the incoming ray.
    Scene cotangents are zero on every lane but a surviving scatter."""
    unit_rand, coin_u, _ = draws
    one = torch.ones_like(wr)
    zero = torch.zeros_like(wr)
    zero3 = Vec3(zero, zero, zero)
    pr = _bounce_primal(wc, wr, walb, wfuzz, wior, wmat, hit, o, d, atten,
                        alive, bounce, rr_start, draws)
    survives, miss, m, sc = pr.survives, pr.miss, pr.m, pr.sc
    normal, front, ior_safe = pr.normal, pr.front, pr.ior
    is_lam = wmat == LAMBERTIAN
    is_metal = wmat == METAL
    is_diel = wmat == DIELECTRIC

    # ---- pass-through and the miss's sky --------------------------------
    thru = ~survives
    d_o = vec.where(thru, ct_o, zero3)
    d_d = vec.where(thru, ct_d, zero3)
    d_at = vec.where(thru, ct_at, zero3)
    gm = vec.where(miss, g, zero3)
    d_at = d_at + gm * pr.sky
    d_d = d_d + vec.where(miss, sky_vjp(d, gm * atten), zero3)

    # ---- a surviving scatter ---------------------------------------------
    ct_p = ct_o
    ct_dir = ct_d
    ct_m = ct_at
    if rr_start is not None:
        zone, p_surv, mx = pr.zone, pr.p_surv, pr.mx
        w = torch.where(zone, 1.0 / p_surv, one)
        ct_w = vec.dot(ct_at, m)
        ct_m = ct_at * w
        ct_ps = torch.where(zone, -ct_w / (p_surv * p_surv), zero)
        ct_mx = ct_ps * _dmin(vec.maximum(mx, 0.05), 1.0) * _dmax(mx, 0.05)
        # mx = max(max(x, y), z), half to each side of a tie
        d_m1 = _dmax(torch.maximum(m.x, m.y), m.z)
        d_x = _dmax(m.x, m.y)
        ct_m = ct_m + Vec3(ct_mx * d_m1 * d_x, ct_mx * d_m1 * (1.0 - d_x),
                           ct_mx * (1.0 - d_m1))
    ct_in_at = ct_m * sc.attenuation
    d_walb = vec.where(survives & ~is_diel, ct_m * atten, zero3)

    # direction -> (normal, d, fuzz, ior)
    # lambertian: dir = normal + unit_rand (or normal): ct_n = ct_dir
    ct_n = vec.where(is_lam, ct_dir, zero3)
    ct_d_dir = zero3
    # metal: dir = unit(reflect(d, n)) + unit_rand * fuzz
    refl = vec.reflect(d, normal)
    ct_refl = unit_vjp(refl, ct_dir)
    ct_d_met, ct_n_met = reflect_vjp(d, normal, ct_refl)
    ct_n = vec.where(is_metal, ct_n_met, ct_n)
    ct_d_dir = vec.where(is_metal, ct_d_met, ct_d_dir)
    d_wfuzz = torch.where(survives & is_metal, vec.dot(ct_dir, unit_rand),
                          zero)
    # dielectric (any other id): reflect(ud, n) or refract(ud, n, ri)
    ri = torch.where(front, 1.0 / ior_safe, ior_safe)
    ud = vec.unit(d)
    cos_t = vec.minimum(vec.dot(-ud, normal), 1.0)
    sin_t = f32math.sqrt(vec.maximum(1.0 - cos_t * cos_t, 0.0))
    reflects = (ri * sin_t > 1.0) | (
        materials.schlick_reflectance(cos_t, ri) > coin_u)
    ct_ud_r, ct_n_r = reflect_vjp(ud, normal, ct_dir)
    ct_ud_t, ct_n_t, ct_ri = refract_vjp(ud, normal, ri, ct_dir)
    ct_ud = vec.where(reflects, ct_ud_r, ct_ud_t)
    diel = ~is_lam & ~is_metal
    ct_n = vec.where(diel, vec.where(reflects, ct_n_r, ct_n_t), ct_n)
    ct_d_dir = vec.where(diel, unit_vjp(d, ct_ud), ct_d_dir)
    ct_ri = torch.where(diel & ~reflects, ct_ri, zero)
    ct_ior = torch.where(front, -ct_ri / (ior_safe * ior_safe), ct_ri)
    d_wior = torch.where(survives, ct_ior, zero)

    # normal -> outward -> (hit point, centre, radius)
    ct_out = vec.where(front, ct_n, -ct_n)
    ct_diff = ct_out * (1.0 / pr.rs)
    ct_rs = -vec.dot(ct_out, pr.diff) / (pr.rs * pr.rs)
    ct_wr = torch.where(pr.big, ct_rs, zero)
    ct_p = ct_p + ct_diff
    ct_wc = -ct_diff
    # p = o + d * t
    a, h, c = pr.a, pr.h, pr.c
    ct_o_s = ct_p
    ct_d_s = ct_d_dir + ct_p * pr.t
    ct_t = vec.dot(ct_p, d)
    # t = root * (1 / a)
    ct_root = ct_t * (1.0 / a)
    ct_a = -(ct_t * pr.root) / (a * a)
    # root = h -+ sqrt(disc)
    ct_h = ct_root
    ct_sq = torch.where(pr.take_near, -ct_root, ct_root)
    ct_disc = torch.where(pr.disc > 0.0, ct_sq * (0.5 / pr.sqrtd), zero)
    ct_h = ct_h + ct_disc * (2.0 * h)
    ct_a = ct_a - ct_disc * c
    ct_c = -ct_disc * a
    # c = (|wc|^2 - wr^2 + |o|^2) - 2 wc.o
    ct_wc = ct_wc + wc * (2.0 * ct_c) - o * (2.0 * ct_c)
    ct_wr = ct_wr - wr * (2.0 * ct_c)
    ct_o_s = ct_o_s + o * (2.0 * ct_c) - wc * (2.0 * ct_c)
    # h = wc.d - d.o
    ct_wc = ct_wc + d * ct_h
    ct_d_s = ct_d_s + (wc - o) * ct_h
    ct_o_s = ct_o_s - d * ct_h
    # a = max(|d|^2, 1e-12)
    ct_d_s = ct_d_s + d * (2.0 * ct_a * _dmax(pr.dd, 1e-12))

    s3 = lambda v: vec.where(survives, v, zero3)  # noqa: E731
    return BounceCotangents(
        wc=s3(ct_wc),
        wr=torch.where(survives, ct_wr, zero),
        walb=d_walb,
        wfuzz=d_wfuzz,
        wior=d_wior,
        o=d_o + s3(ct_o_s),
        d=d_d + s3(ct_d_s),
        atten=d_at + s3(ct_in_at),
    )


def primary_ray_vjp(use_defocus, fi, fj, cam_draws, ct_o: Vec3,
                    ct_d: Vec3) -> torch.Tensor:
    """Adjoint of ``tracer.primary_rays_from_ij`` with respect to the 18
    camera scalars, per lane: an (18, R) tensor in pack_camera column
    order (pixel00, delta_u, delta_v, center, disk_u, disk_v).

    ``cam_draws`` = (u0, u1, px, py), the primary ray's detached draws."""
    u0, u1, px, py = cam_draws
    su = fi + (u0 - 0.5)
    sv = fj + (u1 - 0.5)
    ct_origin = ct_o - ct_d
    dz = torch.zeros_like(px)
    on = torch.as_tensor(use_defocus, device=px.device)
    pxs = torch.where(on, px, dz)
    pys = torch.where(on, py, dz)
    rows = [*ct_d, *(ct_d * su), *(ct_d * sv), *ct_origin,
            *(ct_origin * pxs), *(ct_origin * pys)]
    return torch.stack(rows)
