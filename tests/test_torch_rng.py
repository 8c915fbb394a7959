"""The port's Threefry stream and f32 math against the JAX package.

Inputs are made by seeded numpy and handed to both packages. Integer
words must be bit-equal; so must the uniforms (a fixed bit recipe). The
samplers go through sqrt/sin/cos, which the port computes with glibc's
algorithm (ops/f32math.py), equal to XLA's CPU results op by op; the
samplers are run by eager JAX (inside jit XLA fuses ``1 - z*z`` into a
multiply-add) and held to allclose(rtol=1e-6, atol=1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingincuda_torch.ops import f32math
from raytracingincuda_torch.ops import rng as trng
from raytracingincuda_tpu.ops import rng as jrng

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

N = 100_000


def _u32(rng, n, hi=1 << 32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", [1227, 0, 0xDEADBEEF12345678])
def test_threefry_words_bit_equal(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    c0, c1 = _u32(rng, N), _u32(rng, N)
    jk, tk = jrng.key_from_seed(seed), trng.key_from_seed(seed)
    assert (int(jk[0]), int(jk[1])) == tk
    j0, j1 = jrng.threefry2x32(jk[0], jk[1], jnp.asarray(c0), jnp.asarray(c1))
    t0, t1 = trng.threefry2x32(tk[0], tk[1], _t(c0), _t(c1))
    np.testing.assert_array_equal(np.asarray(j0).astype(np.int64), t0.numpy())
    np.testing.assert_array_equal(np.asarray(j1).astype(np.int64), t1.numpy())


def test_make_counter_and_unit_float_bit_equal():
    rng = np.random.default_rng(1)
    sample, bounce, draw = _u32(rng, N), _u32(rng, N, 256), _u32(rng, N, 8)
    jc = jrng.make_counter(jnp.asarray(sample), jnp.asarray(bounce),
                           jnp.asarray(draw))
    tc = trng.make_counter(_t(sample), _t(bounce), _t(draw))
    np.testing.assert_array_equal(np.asarray(jc).astype(np.int64), tc.numpy())

    bits = _u32(rng, N)
    jf = np.asarray(jrng._bits_to_unit_float(jnp.asarray(bits), jnp.float32))
    tf = trng._bits_to_unit_float(_t(bits)).numpy()
    np.testing.assert_array_equal(jf, tf)
    assert tf.min() >= 0.0 and tf.max() < 1.0


def test_uniform2_bit_equal():
    rng = np.random.default_rng(2)
    ids, sample = _u32(rng, N, 1 << 24), _u32(rng, N, 1 << 21)
    key = (jrng.key_from_seed(1227), trng.key_from_seed(1227))
    for bounce, draw in ((0, jrng.DRAW_JITTER), (7, jrng.DRAW_COIN)):
        ju = jrng.uniform2(key[0], jnp.asarray(ids), jnp.asarray(sample),
                           bounce, draw)
        tu = trng.uniform2(key[1], _t(ids), _t(sample), bounce, draw)
        for a, b in zip(ju, tu):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_samplers_allclose():
    rng = np.random.default_rng(3)
    ids, sample = _u32(rng, N, 1 << 24), _u32(rng, N, 1 << 21)
    jk, tk = jrng.key_from_seed(1227), trng.key_from_seed(1227)
    jv = jrng.random_unit_vector(jk, jnp.asarray(ids), jnp.asarray(sample),
                                 3, 0)
    tv = trng.random_unit_vector(tk, _t(ids), _t(sample), 3, 0)
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    jd = jrng.random_in_unit_disk(jk, jnp.asarray(ids), jnp.asarray(sample))
    td = trng.random_in_unit_disk(tk, _t(ids), _t(sample))
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


def _large_ids(seed):
    """N pixel ids from 2^24 up to the port's lane cap: the ends, the last
    pixel of 7680x4320, and draws between."""
    from raytracingincuda_torch.ops.kernel_io import MAX_LANES

    rng = np.random.default_rng(seed)
    ends = [1 << 24, (1 << 24) + 1, 7680 * 4320 - 1, MAX_LANES - 1]
    return np.concatenate([ends, rng.integers(1 << 24, MAX_LANES,
                                              N - len(ends))]).astype(
        np.uint32)


@pytest.mark.parametrize("bounce, draw", [(0, jrng.DRAW_JITTER),
                                          (0, jrng.DRAW_DEFOCUS),
                                          (7, jrng.DRAW_SCATTER),
                                          (255, jrng.DRAW_RR)])
def test_uniform2_bit_equal_past_2_24(bounce, draw):
    """Pixel ids of 2^24 and more, up to the lane cap, key the same words:
    uniform2 bit-equal to JAX's."""
    rng = np.random.default_rng(6)
    ids, sample = _large_ids(6), _u32(rng, N, 1 << 21)
    ju = jrng.uniform2(jrng.key_from_seed(1227), jnp.asarray(ids),
                       jnp.asarray(sample), bounce, draw)
    tu = trng.uniform2(trng.key_from_seed(1227), _t(ids), _t(sample), bounce,
                       draw)
    for a, b in zip(ju, tu):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("sampler", ["random_unit_vector",
                                     "random_in_unit_disk"])
def test_samplers_bit_equal_past_2_24(sampler):
    """The samplers at pixel ids from 2^24 up to the lane cap, eager JAX:
    bit-equal (the sqrt/sin/cos of ops/f32math.py are XLA's op by op)."""
    rng = np.random.default_rng(7)
    ids, sample = _large_ids(7), _u32(rng, N, 1 << 21)
    jk, tk = jrng.key_from_seed(1227), trng.key_from_seed(1227)
    extra = (5, 0) if sampler == "random_unit_vector" else ()
    with jax.disable_jit():
        want = getattr(jrng, sampler)(jk, jnp.asarray(ids),
                                      jnp.asarray(sample), *extra)
    got = getattr(trng, sampler)(tk, _t(ids), _t(sample), *extra)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("fn", ["sin", "cos", "sqrt"])
def test_f32math_bit_equal_to_xla_cpu(fn):
    """XLA's CPU sin/cos are glibc's; sqrt is correctly rounded. The
    port's own versions reproduce them exactly on the samplers' range."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.random(N) * 2 * np.pi, rng.random(N) * 0.8,
                        rng.random(1000) * 1e-4]).astype(np.float32)
    if fn == "sqrt":
        x = x * 1000.0
    want = np.asarray(getattr(jnp, fn)(jnp.asarray(x)))
    got = getattr(f32math, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_f32math_rsqrt_close_to_xla():
    """XLA's CPU rsqrt is a hardware estimate plus two Newton steps; the
    port's is 1/sqrt in f64, rounded: within 2 ulp of each other."""
    x = (np.random.default_rng(5).random(N) * 100 + 1e-3).astype(np.float32)
    want = np.asarray(jax.lax.rsqrt(jnp.asarray(x)))
    got = f32math.rsqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("args", [(1 << 21, 8), ((1 << 21) + 1, 8),
                                  (100, 256), (100, 257)])
def test_validate_stream_ids_alike(args):
    def outcome(fn):
        try:
            fn(*args)
            return None
        except ValueError as e:
            return str(e)

    assert outcome(jrng.validate_stream_ids) == outcome(trng.validate_stream_ids)


@pytest.mark.parametrize("rr", [None, 0, 2, 2.0, 2.5, -1])
def test_validate_rr_start_alike(rr):
    def outcome(fn):
        try:
            return fn(rr)
        except ValueError as e:
            return str(e)

    assert outcome(jrng.validate_rr_start) == outcome(trng.validate_rr_start)
