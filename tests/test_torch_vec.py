"""The port's ``ops/vec.py`` against the JAX package's, case by case.

The cases of ``tests/test_vec.py``, each run on the same seeded numpy
inputs through JAX (op by op, as the JAX test runs them) and through the
port. ``+ - * /``, ``dot``, ``cross``, ``where``, ``lerp``, ``reflect``
and ``near_zero`` are bit-equal; the ``sqrt``-based ``length``, ``unit``
and ``refract`` are within 1 ulp (XLA's and torch's f32 ``sqrt`` differ
by an ulp on about 0.6% of inputs). ``unit`` takes XLA's ``rsqrt`` in
JAX, 1 ulp off the port's correctly rounded one on 13-17% of inputs: the
factor is held within 1 ulp, the product by the same factor bit for bit,
and the components, which round a 1-ulp factor once more, within 2 ulp
(measured: 2). The JAX file's pytree round-trip has no torch counterpart
(the port's ``Vec3`` is a plain NamedTuple) and is left out; the ``Vec3``
helpers the port took from JAX's (``of``, ``from_stacked``, ``astype``,
``reshape``, ``shape``, ``dtype``) have a case of their own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingincuda_torch.ops import f32math
from raytracingincuda_torch.ops import vec as tvec
from raytracingincuda_torch.ops.vec import Vec3 as TV
from raytracingincuda_tpu.ops import vec as jvec
from raytracingincuda_tpu.ops.vec import Vec3 as JV

torch.set_num_threads(1)


def rand_vec3(rng, n=64):
    a = rng.standard_normal((3, n)).astype(np.float32)
    return JV(*map(jnp.asarray, a)), TV(*map(torch.from_numpy, a)), a


def both(v_j, v_t):
    """The JAX and port results as numpy arrays, components on axis 0."""
    def arr(v, conv):
        return np.stack([conv(c) for c in v]) if isinstance(v, tuple) \
            else conv(v)
    return arr(v_j, np.asarray), arr(v_t, lambda t: t.numpy())


def assert_bit_equal(v_j, v_t):
    j, t = both(v_j, v_t)
    assert j.dtype == t.dtype
    np.testing.assert_array_equal(t, j)


def assert_within_ulp(v_j, v_t):
    j, t = both(v_j, v_t)
    np.testing.assert_array_max_ulp(t, j, maxulp=1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_arithmetic_matches_jax(rng):
    uj, ut, ua = rand_vec3(rng)
    vj, vt, va = rand_vec3(rng)
    for f in (lambda u, v: u + v, lambda u, v: u - v, lambda u, v: u * v,
              lambda u, v: u * 2.5, lambda u, v: 2.5 * u,
              lambda u, v: u / 2.0, lambda u, v: -u):
        assert_bit_equal(f(uj, vj), f(ut, vt))
    np.testing.assert_allclose((ut + vt).stack(0).numpy(), ua + va,
                               rtol=1e-6)


def test_dot_cross(rng):
    uj, ut, ua = rand_vec3(rng)
    vj, vt, va = rand_vec3(rng)
    assert_bit_equal(jvec.dot(uj, vj), tvec.dot(ut, vt))
    assert_bit_equal(jvec.cross(uj, vj), tvec.cross(ut, vt))
    np.testing.assert_allclose(tvec.dot(ut, vt).numpy(), (ua * va).sum(0),
                               rtol=1e-5)
    np.testing.assert_allclose(tvec.dot(tvec.cross(ut, vt), ut).numpy(),
                               np.zeros(64), atol=1e-4)


def test_unit_and_length(rng):
    uj, ut, ua = rand_vec3(rng)
    assert_bit_equal(jvec.length_sq(uj), tvec.length_sq(ut))
    assert_within_ulp(jvec.length(uj), tvec.length(ut))
    # unit scales by rsqrt(|v|^2): the factor is within 1 ulp of XLA's,
    # and the port's product by XLA's factor is JAX's unit bit for bit;
    # a 1-ulp factor moves a rounded product by up to 2 ulp
    inv_j = jax.lax.rsqrt(jnp.maximum(jvec.length_sq(uj), 1e-30))
    inv_t = f32math.rsqrt(tvec.maximum(tvec.length_sq(ut), 1e-30))
    assert_within_ulp(inv_j, inv_t)
    assert_bit_equal(jvec.unit(uj), ut * torch.tensor(np.asarray(inv_j)))
    np.testing.assert_array_max_ulp(*both(jvec.unit(uj), tvec.unit(ut)),
                                    maxulp=2)
    np.testing.assert_allclose(tvec.length(ut).numpy(),
                               np.linalg.norm(ua, axis=0), rtol=1e-5)
    np.testing.assert_allclose(tvec.length(tvec.unit(ut)).numpy(),
                               np.ones(64), rtol=1e-5)
    # a zero vector stays finite
    z = tvec.unit(TV.zeros((4,)))
    assert_bit_equal(jvec.unit(JV.zeros((4,))), z)
    assert np.isfinite(z.stack(0).numpy()).all()


def test_near_zero_and_where():
    a = np.array([[1e-7, 1e-3], [1e-7, 1e-7], [0.0, 0.0]], np.float32)
    vj, vt = JV(*map(jnp.asarray, a)), TV(*map(torch.from_numpy, a))
    assert_bit_equal(jvec.near_zero(vj), tvec.near_zero(vt))
    np.testing.assert_array_equal(tvec.near_zero(vt).numpy(), [True, False])
    m = np.array([True, False])
    b = np.ones_like(a)
    assert_bit_equal(jvec.where(jnp.asarray(m), vj,
                                JV(*map(jnp.asarray, b))),
                     tvec.where(torch.from_numpy(m), vt,
                                TV(*map(torch.from_numpy, b))))


def test_reflect(rng):
    # 45-degree reflection off the y plane, and seeded normals
    assert_bit_equal(jvec.reflect(JV.of(1.0, -1.0, 0.0), JV.of(0.0, 1.0, 0.0)),
                     tvec.reflect(TV.of(1.0, -1.0, 0.0), TV.of(0.0, 1.0, 0.0)))
    r = tvec.reflect(TV.of(1.0, -1.0, 0.0), TV.of(0.0, 1.0, 0.0))
    np.testing.assert_allclose([float(c) for c in r], [1.0, 1.0, 0.0],
                               atol=1e-6)
    dj, dt, _ = rand_vec3(rng)
    nj, nt, _ = rand_vec3(rng)
    assert_bit_equal(jvec.reflect(dj, jvec.unit(nj)),
                     tvec.reflect(dt, TV(*(torch.tensor(np.asarray(c))
                                           for c in jvec.unit(nj)))))


def test_refract_straight_through():
    # normal incidence: direction unchanged whatever eta
    rj = jvec.refract(JV.of(0.0, -1.0, 0.0), JV.of(0.0, 1.0, 0.0),
                      jnp.float32(1.5))
    rt = tvec.refract(TV.of(0.0, -1.0, 0.0), TV.of(0.0, 1.0, 0.0),
                      torch.tensor(1.5))
    assert_within_ulp(rj, rt)
    np.testing.assert_allclose([float(c) for c in rt], [0.0, -1.0, 0.0],
                               atol=1e-6)


def test_refract_snells_law(rng):
    # oblique incidence: sin(theta_out) = eta * sin(theta_in)
    theta_in, eta = 0.5, 0.7
    args = (np.sin(theta_in), -np.cos(theta_in), 0.0)
    rj = jvec.refract(JV.of(*args), JV.of(0.0, 1.0, 0.0), jnp.float32(eta))
    rt = tvec.refract(TV.of(*args), TV.of(0.0, 1.0, 0.0), torch.tensor(eta))
    assert_within_ulp(rj, rt)
    sin_out = float(rt.x) / float(tvec.length(rt))
    np.testing.assert_allclose(sin_out, eta * np.sin(theta_in), rtol=1e-5)
    # seeded unit directions and normals, glass both ways
    uj, ut, _ = rand_vec3(rng)
    nj, nt, _ = rand_vec3(rng)
    eta = np.where(rng.random(64) < 0.5, 1 / 1.5, 1.5).astype(np.float32)
    ud, nd = jvec.unit(uj), jvec.unit(nj)
    assert_within_ulp(
        jvec.refract(ud, nd, jnp.asarray(eta)),
        tvec.refract(TV(*(torch.tensor(np.asarray(c)) for c in ud)),
                     TV(*(torch.tensor(np.asarray(c)) for c in nd)),
                     torch.from_numpy(eta)))


def test_lerp_endpoints(rng):
    a, b = (1.0, 1.0, 1.0), (0.5, 0.7, 1.0)
    for t in (0.0, 1.0):
        lt = tvec.lerp(torch.tensor(t), TV.of(*a), TV.of(*b))
        assert_bit_equal(jvec.lerp(jnp.float32(t), JV.of(*a), JV.of(*b)), lt)
        np.testing.assert_allclose(float(lt.y), 1.0 if t == 0.0 else 0.7,
                                   atol=1e-6)
    t = rng.random(64).astype(np.float32)
    assert_bit_equal(jvec.lerp(jnp.asarray(t), JV.of(*a), JV.of(*b)),
                     tvec.lerp(torch.from_numpy(t), TV.of(*a), TV.of(*b)))


def test_vec3_helpers_match_jax(rng):
    uj, ut, ua = rand_vec3(rng, 12)
    assert tuple(ut.shape) == uj.shape == (12,)
    assert ut.dtype == torch.float32 and uj.dtype == jnp.float32
    assert_bit_equal(uj.reshape(3, 4), ut.reshape(3, 4))
    assert_bit_equal(uj.astype(jnp.float16), ut.astype(torch.float16))
    assert_bit_equal(JV.from_stacked(uj.stack()),
                     TV.from_stacked(ut.stack()))
    assert_bit_equal(JV.from_stacked(uj.stack(0), 0),
                     TV.from_stacked(ut.stack(0), 0))
    assert_bit_equal(JV.of(0.1, 0.2, 0.3), TV.of(0.1, 0.2, 0.3))
    np.testing.assert_array_equal(ut.stack(0).numpy(), ua)
