"""The port's intersection, scatter and oracle tracer against the JAX package.

Module tests run JAX eagerly (op by op), where XLA's arithmetic is the
port's: the hit test must agree bit for bit. Scatter differs only where
``unit`` takes XLA's approximate rsqrt (metal and dielectric lanes): held
to allclose(atol=1e-6). Images rendered by JAX op by op are held to the
JAX package's golden gate; images XLA compiled (jit, and the committed
goldens) to the cross-framework gate of ``utils/ppm.py``, since XLA fuses
multiply-adds and the last-bit differences flip a few knife-edge paths.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingincuda_torch.models import materials as tmat
from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.scene import build_scene as t_build
from raytracingincuda_torch.ops import intersect as tint
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import tracer as ttr
from raytracingincuda_torch.ops.vec import Vec3 as TV
from raytracingincuda_torch.utils import ppm
from raytracingincuda_tpu.models import materials as jmat
from raytracingincuda_tpu.models.camera import CameraConfig as JCam
from raytracingincuda_tpu.models.scene import build_scene as j_build
from raytracingincuda_tpu.ops import intersect as jint
from raytracingincuda_tpu.ops import tracer as jtr
from raytracingincuda_tpu.ops.vec import Vec3 as JV

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
R = 4096


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-12, 12, R), rng.uniform(0.1, 3, R),
                  rng.uniform(-12, 12, R)]).astype(np.float32)
    d = rng.standard_normal((3, R)).astype(np.float32)
    return o, d


def _jv(a):
    return JV(*map(jnp.asarray, a))


def _tv(a):
    return TV(*map(torch.from_numpy, a))


@pytest.mark.parametrize("scene_id", [1, 2])
def test_hit_world_bit_equal_to_eager_jax(scene_id):
    o, d = _rays(scene_id)
    jh = jint.hit_world(j_build(scene_id), _jv(o), _jv(d))
    th = tint.hit_world(t_build(scene_id), _tv(o), _tv(d))
    hit = np.asarray(jh.hit)
    assert 0.2 < hit.mean() < 0.8
    np.testing.assert_array_equal(th.hit.numpy(), hit)
    np.testing.assert_array_equal(th.idx.numpy()[hit], np.asarray(jh.idx)[hit])
    np.testing.assert_array_equal(th.t.numpy(), np.asarray(jh.t))


def test_scatter_vs_eager_jax():
    rng = np.random.default_rng(11)
    o, d = _rays(11)
    n = rng.standard_normal((3, R)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0)
    u = rng.standard_normal((3, R)).astype(np.float32)
    u /= np.linalg.norm(u, axis=0)
    ff = rng.random(R) < 0.5
    mat = rng.integers(0, 3, R).astype(np.int32)
    alb = rng.random((3, R)).astype(np.float32)
    fuzz = (rng.random(R) * 0.5).astype(np.float32)
    ior = np.full(R, 1.5, np.float32)
    coin = rng.random(R).astype(np.float32)
    js = jmat.scatter(_jv(d), _jv(n), jnp.asarray(ff), jnp.asarray(mat),
                      _jv(alb), jnp.asarray(fuzz), jnp.asarray(ior), _jv(u),
                      jnp.asarray(coin))
    ts = tmat.scatter(_tv(d), _tv(n), torch.from_numpy(ff),
                      torch.from_numpy(mat), _tv(alb), torch.from_numpy(fuzz),
                      torch.from_numpy(ior), _tv(u), torch.from_numpy(coin))
    np.testing.assert_array_equal(ts.scattered.numpy(), np.asarray(js.scattered))
    for a, b in zip(js.attenuation, ts.attenuation):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    lam = mat == 0  # no rsqrt on the lambertian branch: exact
    for a, b in zip(js.direction, ts.direction):
        np.testing.assert_array_equal(b.numpy()[lam], np.asarray(a)[lam])
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_schlick_pow5_is_jax_integer_pow():
    x = np.random.default_rng(12).random(R).astype(np.float32)
    want = np.asarray(jnp.asarray(x) ** 5)
    np.testing.assert_array_equal(tmat.pow5(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("scene_id", [1, 2, 3])
@pytest.mark.parametrize("rr_start", [None, 2])
def test_oracle_vs_jax_oracle(scene_id, rr_start):
    """Against JAX run op by op: the JAX package's own golden gate."""
    kw = dict(sample_offset=3, rr_start=rr_start)
    args = (JCam.reference_default(), 24, 16, 2, 6)
    got = ttr.render(t_build(scene_id), TCam.reference_default(), 24, 16, 2,
                     6, **kw).numpy()
    with jax.disable_jit():
        eager = np.asarray(jtr.render(j_build(scene_id), *args, **kw))
    st = ppm.diff_stats(got, ppm.quantize(eager))
    assert ppm.passes_golden_gate(st), st


@pytest.mark.parametrize("scene_id", [1, 2, 3])
def test_oracle_matches_golden(scene_id):
    golden, maxval = ppm.read_ppm(
        os.path.join(GOLDEN_DIR, f"scene{scene_id}_48x30_4spp_8b.ppm"))
    assert maxval == 255
    img = ttr.render(t_build(scene_id), TCam.reference_default(), 48, 30, 4, 8)
    st = ppm.diff_stats(img.numpy(), golden)
    assert ppm.passes_cross_framework_gate(st), st


def test_oracle_chunking_and_offsets_exact():
    """Counter-based streams: any chunk size gives the same bits, and two
    accumulate-only passes add up to the one-pass sum."""
    s, cam = t_build(2), TCam.reference_default()
    full = ttr.render(s, cam, 20, 12, 4, 5, accumulate_only=True)
    chunked = ttr.render(s, cam, 20, 12, 4, 5, accumulate_only=True,
                         chunk_pixels=64)
    assert torch.equal(full, chunked)
    a = ttr.render(s, cam, 20, 12, 2, 5, accumulate_only=True)
    b = ttr.render(s, cam, 20, 12, 2, 5, accumulate_only=True,
                   sample_offset=2)
    torch.testing.assert_close(a + b, full, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("legacy_sky", [False, True])
def test_oracle_equals_regen_reference(legacy_sky):
    """The oracle and the kernel's plain version trace the same paths in
    another order; every float op is the same, so the images are equal."""
    s, cam = t_build(1), TCam.reference_default()
    kw = dict(legacy_sky=legacy_sky, rr_start=1)
    want = ttr.render(s, cam, 16, 8, 3, 6, **kw)
    got = rk.render_kernel(s, cam, 16, 8, 3, 6, **kw)
    assert torch.equal(got, want)
