"""The hand-written bounce adjoint (ops/backward.py) against JAX.

``winner_bounce`` is held to the JAX package's ``_winner_bounce`` and
``winner_bounce_vjp`` to ``jax.vjp`` of it, both run op by op, on rays
cast at a scene of every material (lambertian, fuzzed metal, glass, and
hollow glass with a negative radius), with live misses, dead lanes and
attenuations tied at 1 (the RR clip's upper bound), with RR on and off.
The adjoint is also held to torch autograd through ``winner_bounce``;
``primary_ray_vjp`` to ``jax.vjp`` of ``primary_rays_from_ij``.

Tolerances: eager JAX computes rsqrt from a hardware estimate (ROADMAP
queue 3), so primals differ in the last bits and cotangents, which
multiply many of them, by up to about 1e-4 of the array's largest entry
near grazing hits; the tests allow 5e-4 of it. Against torch autograd
(the same primal) the allowance is 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import scene_from_spheres
from raytracingincuda_torch.models.convert import scene_from_numpy
from raytracingincuda_torch.ops import backward as tb
from raytracingincuda_torch.ops import rng as trng
from raytracingincuda_torch.ops.tracer import (primary_ray_draws,
                                               primary_rays_from_ij)
from raytracingincuda_torch.ops.vec import Vec3 as TV
from raytracingincuda_tpu.models.camera import CameraConfig as JCam
from raytracingincuda_tpu.models.camera import initialize as j_initialize
from raytracingincuda_tpu.models.scene import DIELECTRIC, LAMBERTIAN, METAL
from raytracingincuda_tpu.ops import pallas_backward as jpb
from raytracingincuda_tpu.ops import rng as jrng
from raytracingincuda_tpu.ops import tracer as jtr
from raytracingincuda_tpu.ops.pallas_kernel import pack_camera as j_pack_camera
from raytracingincuda_tpu.ops.vec import Vec3 as JV

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

R = 4096
VS_JAX = 5e-4       # of the largest |entry|, against eager jax.vjp
VS_AUTOGRAD = 2e-5  # of the largest |entry|, against torch autograd
NAMES = ("wc", "wr", "walb", "wfuzz", "wior", "o", "d", "atten")


def _jscene():
    return scene_from_spheres([
        dict(center=(0, -1000, 0), radius=1000.0, mat=LAMBERTIAN,
             albedo=(0.5, 0.5, 0.5)),
        dict(center=(0, 1, 0), radius=1.0, mat=DIELECTRIC, ior=1.5),
        dict(center=(-2, 1, 0), radius=1.0, mat=LAMBERTIAN,
             albedo=(0.4, 0.2, 0.1)),
        dict(center=(2, 1, 0), radius=1.0, mat=METAL, albedo=(0.7, 0.6, 0.5),
             fuzz=0.1),
        dict(center=(0, 1, 0), radius=-0.8, mat=DIELECTRIC, ior=1.5),
    ], pad_to=8)


def _np3(v):
    return np.stack([np.asarray(x) for x in v])


def _tv(a):
    return TV(*(torch.from_numpy(np.ascontiguousarray(x)) for x in a))


def _jv(a):
    return JV(*(jnp.asarray(x) for x in a))


@pytest.fixture(scope="module")
def lanes():
    """Rays from random origins (a fifth inside the glass) to random
    targets, the full scan's winner, and random states and cotangents."""
    rng = np.random.default_rng(0)
    o = np.stack([rng.uniform(-4, 4, R), rng.uniform(0.2, 3, R),
                  rng.uniform(-4, 4, R)]).astype(np.float32)
    inside = rng.random(R) < 0.2
    o[:, inside] = (np.array([[0.0], [1.0], [0.0]]) + 0.5 * rng.uniform(
        -1, 1, (3, inside.sum()))).astype(np.float32)
    tgt = np.stack([rng.uniform(-2.5, 2.5, R), rng.uniform(-0.5, 6, R),
                    rng.uniform(-1.5, 1.5, R)]).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    scene = scene_from_numpy([np.asarray(x) for x in
                              jax.tree_util.tree_leaves(_jscene())])
    w = tb.hit_winner(scene, _tv(o), _tv(d))
    atten = rng.uniform(0.2, 1.0, (3, R)).astype(np.float32)
    atten[:, :400] = 1.0                  # max channel 1: the clip's tie
    alive = rng.random(R) < 0.9
    ur = rng.standard_normal((3, R)).astype(np.float32)
    ur /= np.linalg.norm(ur, axis=0)
    coin = rng.random(R).astype(np.float32)
    u_rr = rng.random(R).astype(np.float32)
    cts = [rng.standard_normal((3, R)).astype(np.float32) for _ in range(4)]
    hit = w.hit.numpy()
    kind = np.where(~alive, "dead", np.where(~hit, "miss", "lambertian"))
    mat = w.mat.numpy()
    kind = np.where(alive & hit & (mat == METAL), "metal", kind)
    kind = np.where(alive & hit & (mat == DIELECTRIC), "glass", kind)
    kind = np.where(alive & hit & (w.radius.numpy() < 0), "hollow_glass", kind)
    return dict(o=o, d=d, w=w, atten=atten, alive=alive,
                draws=(ur, coin, u_rr), cts=cts, kind=kind)


def _torch_args(L):
    w = L["w"]
    return (w.center, w.radius, w.albedo, w.fuzz, w.ior, w.mat, w.hit,
            _tv(L["o"]), _tv(L["d"]), _tv(L["atten"]),
            torch.from_numpy(L["alive"]))


def _torch_draws(L):
    ur, coin, u_rr = L["draws"]
    return _tv(ur), torch.from_numpy(coin), torch.from_numpy(u_rr)


def _jax_fn(L, rr):
    w = L["w"]
    ur, coin, u_rr = L["draws"]
    draws = (_jv(ur), jnp.asarray(coin), jnp.asarray(u_rr))
    wmat = jnp.asarray(w.mat.numpy().astype(np.float32))
    hit = jnp.asarray(w.hit.numpy())

    def f(wc, wr, walb, wfuzz, wior, o, d, at, al):
        return jpb._winner_bounce(wc, wr, walb, wfuzz, wior, wmat, hit, o, d,
                                  at, al, None, None, jnp.uint32(3), None,
                                  jnp.float32, rr_start=rr, draws=draws)

    primals = (_jv(_np3(w.center)), jnp.asarray(w.radius.numpy()),
               _jv(_np3(w.albedo)), jnp.asarray(w.fuzz.numpy()),
               jnp.asarray(w.ior.numpy()), _jv(L["o"]), _jv(L["d"]),
               _jv(L["atten"]), jnp.asarray(L["alive"].astype(np.float32)))
    return f, primals


@pytest.fixture(scope="module")
def jax_results(lanes):
    """Eager JAX forward and vjp for RR off and on (rr_start=0)."""
    out = {}
    for rr in (None, 0):
        f, primals = _jax_fn(lanes, rr)
        c = lanes["cts"]
        with jax.disable_jit():
            primal_out, vjp = jax.vjp(f, *primals)
            ct = vjp(((_jv(c[0]), _jv(c[1]), _jv(c[2]), jnp.zeros(R)),
                      _jv(c[3])))
        out[rr] = (primal_out, ct)
    return out


def _flat(x):
    if isinstance(x, (JV, TV)):
        return np.stack([np.asarray(v) for v in x])
    return np.asarray(x)


def _assert_close(got, want, frac, mask, what):
    got, want = _flat(got)[..., mask], _flat(want)[..., mask]
    scale = max(float(np.abs(want).max()), 1e-6)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale,
                               err_msg=what)


KINDS = ["lambertian", "metal", "glass", "hollow_glass", "miss", "dead"]


@pytest.mark.parametrize("rr", [None, 0])
@pytest.mark.parametrize("kind", KINDS)
def test_winner_bounce_matches_jax(lanes, jax_results, kind, rr):
    mask = lanes["kind"] == kind
    assert mask.sum() > 50, (kind, mask.sum())
    (jo, jd, jat, jal), jcontrib = jax_results[rr][0]
    (to, td, tat, tal), tcontrib = tb.winner_bounce(
        *_torch_args(lanes), bounce=3, rr_start=rr, draws=_torch_draws(lanes))
    np.testing.assert_array_equal(tal.numpy()[mask],
                                  np.asarray(jal)[mask] > 0.5)
    for name, a, b in (("o", to, jo), ("d", td, jd), ("atten", tat, jat),
                       ("contrib", tcontrib, jcontrib)):
        # eager JAX's rsqrt estimate moves metal and glass directions
        # by a few ulps; nothing else differs
        np.testing.assert_allclose(_flat(a)[:, mask], _flat(b)[:, mask],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("rr", [None, 0])
@pytest.mark.parametrize("kind", KINDS)
def test_winner_bounce_vjp_matches_jax_vjp(lanes, jax_results, kind, rr):
    mask = lanes["kind"] == kind
    c = [_tv(x) for x in lanes["cts"]]
    got = tb.winner_bounce_vjp(*_torch_args(lanes), *c, bounce=3,
                               rr_start=rr, draws=_torch_draws(lanes))
    want = jax_results[rr][1]
    for name, g, w in zip(NAMES, got, want):
        _assert_close(g, w, VS_JAX, mask, f"{kind} rr={rr} d_{name}")
    if kind in ("miss", "dead"):  # no scene cotangent off a scatter
        for g in got[:5]:
            assert not _flat(g)[..., mask].any()


@pytest.mark.parametrize("rr", [None, 0])
def test_winner_bounce_vjp_matches_torch_autograd(lanes, rr):
    w = lanes["w"]
    leaves = [t.clone().requires_grad_(True) for t in (
        *w.center, w.radius, *w.albedo, w.fuzz, w.ior,
        *_tv(lanes["o"]), *_tv(lanes["d"]), *_tv(lanes["atten"]))]
    wc, wr, walb = TV(*leaves[0:3]), leaves[3], TV(*leaves[4:7])
    o, d, at = TV(*leaves[9:12]), TV(*leaves[12:15]), TV(*leaves[15:18])
    (o2, d2, at2, _), contrib = tb.winner_bounce(
        wc, wr, walb, leaves[7], leaves[8], w.mat, w.hit, o, d, at,
        torch.from_numpy(lanes["alive"]), bounce=3, rr_start=rr,
        draws=_torch_draws(lanes))
    c = [_tv(x) for x in lanes["cts"]]
    outs = [*o2, *d2, *at2, *contrib]
    cots = [*c[0], *c[1], *c[2], *c[3]]
    auto = torch.autograd.grad(outs, leaves, cots)
    got = tb.winner_bounce_vjp(*_torch_args(lanes), *c, bounce=3,
                               rr_start=rr, draws=_torch_draws(lanes))
    flat_got = [*got.wc, got.wr, *got.walb, got.wfuzz, got.wior, *got.o,
                *got.d, *got.atten]
    every = np.ones(R, bool)
    for k, (g, a) in enumerate(zip(flat_got, auto)):
        _assert_close(g, a, VS_AUTOGRAD, every, f"leaf {k} rr={rr}")


@pytest.mark.parametrize("defocus", [0.6, 0.0])
def test_primary_ray_vjp_matches_jax_vjp(defocus):
    """The adjoint of the primary ray with respect to the 18 camera
    scalars, summed over lanes as the kernels sum it."""
    cfg = JCam.reference_default()._replace(
        defocus_angle=jnp.asarray(defocus, jnp.float32))
    row = np.asarray(j_pack_camera(j_initialize(cfg, 24, 16)))
    use_defocus = bool(row[0, 18] > 0.5)
    n = 384
    pid = np.arange(n, dtype=np.uint32)
    fi, fj = (pid % 24).astype(np.float32), (pid // 24).astype(np.float32)
    key = jrng.key_from_seed(1227)
    rng = np.random.default_rng(4)
    ct_o, ct_d = (rng.standard_normal((3, n)).astype(np.float32)
                  for _ in range(2))

    def f(vals):
        cam = jpb._camera_from_scalars(vals, use_defocus)
        return jtr.primary_rays_from_ij(cam, jnp.asarray(fi), jnp.asarray(fj),
                                        jnp.asarray(pid), jnp.uint32(5), key)

    vals = tuple(jnp.asarray(row[0, k]) for k in range(18))
    with jax.disable_jit():
        _, vjp = jax.vjp(f, vals)
        (want,) = vjp((_jv(ct_o), _jv(ct_d)))
    want = np.array([float(v) for v in want])
    draws = primary_ray_draws(torch.from_numpy(pid.astype(np.int64)), 5,
                              trng.key_from_seed(1227))
    got = tb.primary_ray_vjp(torch.tensor(use_defocus), torch.from_numpy(fi),
                             torch.from_numpy(fj), draws, _tv(ct_o),
                             _tv(ct_d)).sum(dim=1).numpy()
    # lane sums in another order: relative 1e-5 of the largest entry
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if not use_defocus:
        assert not got[12:18].any()
    # and torch autograd through primary_rays_from_ij(camera_from_scalars)
    vals = [torch.tensor(float(row[0, k]), requires_grad=True)
            for k in range(18)]
    cam = tb.camera_from_scalars(vals, torch.tensor(use_defocus))
    o, d = primary_rays_from_ij(cam, torch.from_numpy(fi),
                                torch.from_numpy(fj),
                                torch.from_numpy(pid.astype(np.int64)), 5,
                                trng.key_from_seed(1227))
    auto = torch.autograd.grad([*o, *d], vals, [*_tv(ct_o), *_tv(ct_d)],
                               allow_unused=True)
    auto = np.array([0.0 if a is None else float(a) for a in auto])
    np.testing.assert_allclose(got, auto, rtol=0,
                               atol=1e-5 * np.abs(want).max())
