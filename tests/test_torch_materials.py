"""The port's ``models/materials.py`` against the JAX package's, case by case.

The cases of ``tests/test_materials.py``, each run on the same numpy
inputs through JAX (op by op, as the JAX test runs them) and through the
port, with ``tests/test_torch_tracer.py::test_scatter_vs_eager_jax``'s
tolerance: ``scattered`` and ``attenuation`` bit-equal; the direction
bit-equal on lambertian lanes and within 1e-6 elsewhere, where ``unit``
takes XLA's approximate ``rsqrt`` in JAX. Each case keeps the JAX test's
own assertions, on the port's result.
"""
import jax.numpy as jnp
import numpy as np
import torch

from raytracingincuda_torch.models import materials as tmat
from raytracingincuda_torch.ops.vec import Vec3 as TV
from raytracingincuda_tpu.models import materials as jmat
from raytracingincuda_tpu.models.scene import DIELECTRIC, LAMBERTIAN, METAL
from raytracingincuda_tpu.ops.vec import Vec3 as JV

torch.set_num_threads(1)


def _inputs(n, mat, d_in, normal, front_face=True, albedo=(0.5, 0.5, 0.5),
            fuzz=0.0, ior=1.5, unit_rand=(0.0, 1.0, 0.0), coin=0.99):
    """scatter's nine arguments as numpy arrays of ``n`` lanes; ``mat`` is
    one id or one per lane."""
    def vec(v):
        return np.tile(np.asarray(v, np.float32)[:, None], (1, n))

    def lanes(v, dtype):
        return np.broadcast_to(np.asarray(v, dtype), (n,)).copy()

    return (vec(d_in), vec(normal), lanes(front_face, bool),
            lanes(mat, np.int32), vec(albedo), lanes(fuzz, np.float32),
            lanes(ior, np.float32), vec(unit_rand), lanes(coin, np.float32))


def run_both(args):
    """scatter through JAX and the port; returns the port's result after
    holding it to JAX's."""
    d, nrm, ff, mat, alb, fz, ior, u, coin = args
    js = jmat.scatter(JV(*map(jnp.asarray, d)), JV(*map(jnp.asarray, nrm)),
                      jnp.asarray(ff), jnp.asarray(mat),
                      JV(*map(jnp.asarray, alb)), jnp.asarray(fz),
                      jnp.asarray(ior), JV(*map(jnp.asarray, u)),
                      jnp.asarray(coin))
    t = torch.from_numpy
    ts = tmat.scatter(TV(*map(t, d)), TV(*map(t, nrm)), t(ff), t(mat),
                      TV(*map(t, alb)), t(fz), t(ior), TV(*map(t, u)),
                      t(coin))
    np.testing.assert_array_equal(ts.scattered.numpy(),
                                  np.asarray(js.scattered))
    for a, b in zip(js.attenuation, ts.attenuation):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    lam = mat == LAMBERTIAN
    for a, b in zip(js.direction, ts.direction):
        np.testing.assert_array_equal(b.numpy()[lam], np.asarray(a)[lam])
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    return ts


def direction(out, lane=0):
    return np.array([float(c[lane]) for c in out.direction])


def test_schlick_limits():
    for cos in (1.0, 0.0):
        want = jmat.schlick_reflectance(jnp.float32(cos), jnp.float32(1.5))
        got = tmat.schlick_reflectance(torch.tensor(cos), torch.tensor(1.5))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # normal incidence: r0 = ((1-ri)/(1+ri))^2; grazing: reflectance -> 1
    r = tmat.schlick_reflectance(torch.tensor(1.0), torch.tensor(1.5))
    np.testing.assert_allclose(float(r), ((1 - 1.5) / (1 + 1.5)) ** 2,
                               rtol=1e-6)
    r = tmat.schlick_reflectance(torch.tensor(0.0), torch.tensor(1.5))
    np.testing.assert_allclose(float(r), 1.0, rtol=1e-6)


def test_lambertian_direction_and_albedo():
    out = run_both(_inputs(4, LAMBERTIAN, (0, -1, 0), (0, 1, 0),
                           unit_rand=(1, 0, 0), albedo=(0.3, 0.2, 0.1)))
    np.testing.assert_allclose(direction(out), [1.0, 1.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(float(out.attenuation.x[0]), 0.3)
    assert bool(out.scattered[0])


def test_lambertian_degenerate_guard():
    # unit_rand == -normal would give a near-zero direction
    out = run_both(_inputs(4, LAMBERTIAN, (0, -1, 0), (0, 1, 0),
                           unit_rand=(0, -1, 0)))
    np.testing.assert_allclose(direction(out), [0.0, 1.0, 0.0], atol=1e-6)


def test_metal_mirror_and_absorption():
    # fuzz 0: the exact unit-length specular reflection
    out = run_both(_inputs(4, METAL, (1, -1, 0), (0, 1, 0),
                           unit_rand=(0, 0, 1)))
    np.testing.assert_allclose(direction(out),
                               np.array([1, 1, 0]) / np.sqrt(2), atol=1e-6)
    assert bool(out.scattered[0])
    # a large fuzz pushing the ray below the surface absorbs it
    out2 = run_both(_inputs(4, METAL, (1, -0.01, 0), (0, 1, 0), fuzz=1.0,
                            unit_rand=(0, -1, 0)))
    assert not bool(out2.scattered[0])


def test_dielectric_refracts_with_low_coin():
    # coin 0.99 above the reflectance at normal incidence: refract
    out = run_both(_inputs(4, DIELECTRIC, (0, -1, 0), (0, 1, 0), ior=1.5,
                           coin=0.99))
    assert float(out.direction.y[0]) < 0
    np.testing.assert_allclose(float(out.attenuation.x[0]), 1.0)


def test_dielectric_total_internal_reflection():
    # leaving glass (front_face False, eta = ior = 1.5) at a grazing angle
    # beyond the critical angle reflects even with coin 1
    grazing = (1.0, -0.2, 0.0)
    out = run_both(_inputs(4, DIELECTRIC, grazing, (0, 1, 0),
                           front_face=False, ior=1.5, coin=1.0))
    d_in = np.array(grazing) / np.linalg.norm(grazing)
    expect = d_in - 2 * d_in[1] * np.array([0.0, 1.0, 0.0])
    np.testing.assert_allclose(direction(out), expect, atol=1e-6)


def test_dielectric_schlick_coin_reflects():
    # coin 0: the reflectance always wins, the ray bounces back up
    out = run_both(_inputs(4, DIELECTRIC, (0, -1, 0), (0, 1, 0), ior=1.5,
                           coin=0.0))
    assert float(out.direction.y[0]) > 0


def test_material_lane_select():
    """A mixed batch: each lane follows its own material."""
    out = run_both(_inputs(3, [LAMBERTIAN, METAL, DIELECTRIC], (0, -1, 0),
                           (0, 1, 0), albedo=(0.3, 0.3, 0.3), ior=1.5,
                           unit_rand=(1, 0, 0), coin=0.99))
    np.testing.assert_allclose(out.attenuation.x.numpy(), [0.3, 0.3, 1.0])
    np.testing.assert_allclose(direction(out, 0), [1, 1, 0], atol=1e-6)
    np.testing.assert_allclose(direction(out, 1), [0, 1, 0], atol=1e-6)
    assert direction(out, 2)[1] < 0
