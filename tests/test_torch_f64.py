"""The render in double precision (``dtype='float64'``, ``ops/f64_kernel.py``).

On the CPU the f64 renderer runs the kernel's plain version
(``f64_reference``). The tests hold it to the JAX double-float kernel
(``render_pallas_df64`` in interpret mode) and to the JAX native-f64
oracle with its samplers pinned to their f32 values, as
``tests/test_df64.py`` pins them, within the JAX package's own df64 bound
of 1e-6 in gamma space. The scene is JAX scene 2 (``tiny_scene``'s build)
carried across with ``models/convert.py``. A window of samples at a
``sample_offset`` (a round of ``render_incremental``) is held to the
pinned oracle's window, and two windows to one. The ``cuda`` tests hold
the CUDA kernel to the plain version on the card, bit for bit, at the
regenerating loop's edge cases and at an offset too, and in two levels on
the two-level scan's scenes and at its rule's slot counts (a group table a
launch, counted, and the same image as the launch made one-level); its
count mode equals the plain count. They skip without a card.
"""
import os

import numpy as np
import pytest
import torch

from raytracingincuda_torch import cli
from raytracingincuda_torch.config import RenderConfig
from raytracingincuda_torch.models.camera import CameraConfig as TCam
from raytracingincuda_torch.models.camera import initialize_f64
from raytracingincuda_torch.models.convert import (camera_config_from_numpy,
                                                   f64_inputs_from_numpy,
                                                   scene_from_numpy)
from raytracingincuda_torch.models.scene import DIELECTRIC, Scene
from raytracingincuda_torch.models.scene import build_scene as t_build
from raytracingincuda_torch.ops import f64_kernel as fk
from raytracingincuda_torch.ops import group_scan as gs
from raytracingincuda_torch.ops import kernel_io as kio
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.render_api import make_renderer
from raytracingincuda_torch.utils import ppm, trace

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

W, H, SPP, DEPTH = 32, 16, 1, 4
# the JAX package's df64 bound against its f64 oracle (tests/test_df64.py)
F64_TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def _leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _carried(tiny_scene, default_camera):
    return (scene_from_numpy(_leaves(tiny_scene), device="cpu"),
            camera_config_from_numpy(_leaves(default_camera)))


def _pinned_f64_oracle(tiny_scene, default_camera, monkeypatch, **kw):
    """The JAX native-f64 oracle with its samplers pinned to their f32
    values (the df64 contract), x64 on only inside; ``kw`` goes to its
    ``render`` (``sample_offset``, ``accumulate_only``)."""
    import jax
    import jax.numpy as jnp

    from raytracingincuda_tpu.ops import rng as jrng
    from raytracingincuda_tpu.ops import tracer as jtr
    from raytracingincuda_tpu.ops.vec import Vec3

    orig_ruv, orig_disk = jrng.random_unit_vector, jrng.random_in_unit_disk

    def ruv(key, rid, s, b, draw, dtype=jnp.float32):
        v = orig_ruv(key, rid, s, b, draw, jnp.float32)
        return Vec3(v.x.astype(dtype), v.y.astype(dtype), v.z.astype(dtype))

    def disk(key, rid, s, dtype=jnp.float32):
        px, py = orig_disk(key, rid, s, jnp.float32)
        return px.astype(dtype), py.astype(dtype)

    monkeypatch.setattr(jrng, "random_unit_vector", ruv)
    monkeypatch.setattr(jrng, "random_in_unit_disk", disk)

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)

    jax.config.update("jax_enable_x64", True)
    try:
        return np.asarray(jtr.render(cast(tiny_scene), cast(default_camera),
                                     W, H, SPP, DEPTH, dtype=jnp.float64,
                                     **kw))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_plain_version_vs_jax_df64_kernel(tiny_scene, default_camera):
    """The JAX df64 inputs carried across: scene hi/lo and camera rows."""
    from raytracingincuda_tpu.ops import df64 as dd
    from raytracingincuda_tpu.ops.df64_trace import (initialize_f64 as
                                                     jinit_f64,
                                                     pack_scene_matrix_df64)
    from raytracingincuda_tpu.ops.pallas_df64 import render_pallas_df64

    want = dd.to_f64(render_pallas_df64(tiny_scene, default_camera, W, H,
                                        SPP, DEPTH, interpret=True))
    sm, row = f64_inputs_from_numpy(*pack_scene_matrix_df64(tiny_scene),
                                    jinit_f64(default_camera, W, H),
                                    device="cpu")
    ids, ii, jj, _ = kio.lane_setup(W, H, None, SPP, 0, None, "cpu")
    acc = fk.f64_reference(ids, ii, jj, sm, row, samples=SPP,
                           max_depth=DEPTH)
    img = acc.t()[:W * H].reshape(H, W, 3) * (1.0 / SPP)
    img = torch.where(img > 0, torch.sqrt(img.clamp(min=0.0)), 0.0).numpy()
    # measured 1.12e-8: compiled by XLA, the f32 sin, cos and sqrt of the
    # JAX unit-vector draws differ from ops/f32math.py's by an ulp on about
    # 10% of lanes (run op by op they are equal), and a scatter direction
    # an ulp away reads another sky value
    assert np.abs(img - want).max() <= F64_TOL
    # the port's own camera row (all 53 bits; the carried hi + lo keeps
    # about 48) gives the same image to 1e-12 (measured 1.25e-13)
    own = fk.render_f64(*_carried(tiny_scene, default_camera), W, H, SPP,
                        DEPTH).numpy()
    assert np.abs(own - img).max() <= 1e-12


def test_plain_version_vs_jax_f64_oracle(tiny_scene, default_camera,
                                         monkeypatch):
    want = _pinned_f64_oracle(tiny_scene, default_camera, monkeypatch)
    got = fk.render_f64(*_carried(tiny_scene, default_camera), W, H, SPP,
                        DEPTH)
    assert got.dtype == torch.float64 and got.shape == (H, W, 3)
    # measured 1.12e-8, the jitted f32 draws as above
    assert np.abs(got.numpy() - want).max() <= F64_TOL


def test_sample_window_vs_jax_f64_oracle(tiny_scene, default_camera,
                                         monkeypatch):
    """Samples [3, 4) as raw sums against the pinned oracle's
    ``sample_offset=3, accumulate_only=True``: the draws are keyed on the
    absolute sample index. ``render_f64(accumulate_only=True)`` returns
    the same sums as an (H, W, 3) image."""
    want = _pinned_f64_oracle(tiny_scene, default_camera, monkeypatch,
                              sample_offset=3, accumulate_only=True)
    scene, cam = _carried(tiny_scene, default_camera)
    inputs = fk.f64_inputs(scene, cam, W, H)
    acc = fk.f64_reference(*inputs, samples=SPP, max_depth=DEPTH,
                           sample_offset=3)
    got = acc.t()[:W * H].reshape(H, W, 3)
    # measured 1.82e-8, the jitted f32 draws as above
    assert np.abs(got.numpy() - want).max() <= F64_TOL
    # not the window [0, 1): the offset moves every draw
    assert np.abs(got.numpy() - fk.render_f64(
        scene, cam, W, H, SPP, DEPTH, accumulate_only=True).numpy()
                  ).max() > 0.1
    assert torch.equal(got, fk.render_f64(scene, cam, W, H, SPP, DEPTH,
                                          sample_offset=3,
                                          accumulate_only=True))


def test_two_windows_sum_to_one():
    """[0, 2) + [2, 4) is [0, 4) up to summation order, with the lanes in
    any order (the sums come back un-permuted)."""
    s, cam = t_build(3, device="cpu"), TCam.reference_default()
    kw = dict(seed=5, accumulate_only=True)
    one = fk.render_f64(s, cam, 24, 16, 4, 5, **kw)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(384))
    two = (fk.render_f64(s, cam, 24, 16, 2, 5, **kw)
           + fk.render_f64(s, cam, 24, 16, 2, 5, sample_offset=2,
                           pixel_order=perm, **kw))
    assert one.dtype == two.dtype == torch.float64
    assert one.shape == (16, 24, 3)
    assert np.abs((one - two).numpy()).max() <= 1e-12


def test_offset_zero_is_the_default_call():
    """At ``sample_offset=0`` every output is the call without it, bit
    for bit: the raw sums, the image, and the image from the sums."""
    s, cam = t_build(1, device="cpu"), TCam.reference_default()
    inputs = fk.f64_inputs(s, cam, 20, 12)
    kw = dict(samples=2, max_depth=6)
    assert torch.equal(fk.f64_reference(*inputs, sample_offset=0, **kw),
                       fk.f64_reference(*inputs, **kw))
    img = fk.render_f64(s, cam, 20, 12, 2, 6)
    assert torch.equal(img, fk.render_f64(s, cam, 20, 12, 2, 6,
                                          sample_offset=0))
    acc = fk.render_f64(s, cam, 20, 12, 2, 6, accumulate_only=True)
    lin = acc * (1.0 / 2)
    assert torch.equal(img, torch.where(lin > 0, fk._sqrt(
        torch.where(lin > 0, lin, 1.0)), 0.0))


def test_sample_window_is_validated_at_its_end():
    """``validate_stream_ids`` takes the window's end, offset + samples,
    as kernel 1's wrapper does; a negative offset raises."""
    from raytracingincuda_torch.ops import rng as rtrng

    inputs = fk.f64_inputs(t_build(2, device="cpu"),
                           TCam.reference_default(), W, H)
    kw = dict(samples=2, max_depth=2)
    fk.f64_reference(*inputs, sample_offset=rtrng.MAX_SAMPLE_ID - 2, **kw)
    with pytest.raises(ValueError, match="exceed the counter field"):
        fk.f64_reference(*inputs, sample_offset=rtrng.MAX_SAMPLE_ID - 1,
                         **kw)
    with pytest.raises(ValueError, match="non-negative"):
        fk.f64_reference(*inputs, sample_offset=-1, **kw)


def test_f64_is_closer_to_the_oracle_than_f32(tiny_scene, default_camera,
                                              monkeypatch):
    """The f64-vs-f32 gap as tests/test_df64.py states it: the port's f64
    image is at least 10x closer to the pinned f64 oracle than the port's
    f32 image, or the f32 image is itself within 1e-6. Measured: 1.12e-8
    against 6.04e-5."""
    want = _pinned_f64_oracle(tiny_scene, default_camera, monkeypatch)
    scene, cam = _carried(tiny_scene, default_camera)
    d64 = np.abs(fk.render_f64(scene, cam, W, H, SPP, DEPTH).numpy()
                 - want).max()
    d32 = np.abs(rk.render_kernel(scene, cam, W, H, SPP, DEPTH).numpy()
                 .astype(np.float64) - want).max()
    assert d64 < d32 / 10 or d32 < F64_TOL, (d64, d32)


@pytest.mark.parametrize("layout", ["vmem", "hbm"])
def test_pixel_order_and_layout_change_nothing(layout):
    s, cam = t_build(3, device="cpu"), TCam.reference_default()
    base = fk.render_f64(s, cam, 24, 16, 2, 5)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(384))
    assert torch.equal(base, fk.render_f64(s, cam, 24, 16, 2, 5,
                                           layout=layout, pixel_order=perm))


def test_make_renderer_f64_cpu(monkeypatch):
    """Raster order at >= 8 spp and > 4 bounces too: no f32 prepass runs;
    ``prepare`` packs the scene ahead."""
    cfg = RenderConfig(scene_id=2, width=20, height=12, samples=8, bounces=5,
                       dtype="float64")
    scene, cam = t_build(2, device="cpu"), TCam.reference_default()
    monkeypatch.setattr(rk, "measure_difficulty", lambda *a, **k: pytest.fail(
        "the f64 renderer ran the f32 prepass"))
    r = make_renderer(cfg, "cpu")
    r.prepare(scene)
    img = r(scene, cam)
    assert img.shape == (12, 20, 3) and img.dtype == torch.float64
    assert torch.equal(img, fk.render_f64(scene, cam, 20, 12, 8, 5))
    assert cfg.output_filename().startswith("const_double_scene2_")


@pytest.mark.parametrize("kw, match", [
    (dict(rr_start=2), "parity estimator"),
    (dict(legacy_sky=True), "parity estimator"),
    (dict(layout="packed"), "packed"),
    (dict(impl="stream"), "impl=stream"),
    (dict(impl="adaptive"), "impl=adaptive"),
])
def test_f64_scope_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        RenderConfig(scene_id=2, dtype="float64", **kw)


def test_wrapper_checks_raise():
    s, cam = t_build(2, device="cpu"), TCam.reference_default()
    ids, ii, jj, sm, row = fk.f64_inputs(s, cam, W, H)
    kw = dict(samples=1, max_depth=2)
    with pytest.raises(ValueError, match="CUDA"):
        fk.f64_kernel(ids, ii, jj, sm, row, **kw)
    with pytest.raises(TypeError):
        fk.f64_reference(ids, ii, jj, sm, row.float(), **kw)
    with pytest.raises(ValueError):
        fk.f64_reference(ids, ii, jj, sm, row, layout="packed", **kw)
    big = torch.zeros((kio.MAX_VMEM_SLOTS + 1, rk.NUM_COLS))
    with pytest.raises(ValueError, match="hbm"):
        fk.f64_reference(ids, ii, jj, big, row, **kw)


def test_cli_cpu_float64_writes_double_file(tmp_path, capsys):
    rc = cli.main(["--scene_id", "2", "--width", "16", "--height", "8",
                   "--samples", "1", "--bounces", "3", "--device", "cpu",
                   "--dtype", "float64", "--outdir", str(tmp_path)])
    assert rc == 0
    assert len(capsys.readouterr().out.strip().split(",")) == 2
    name = "const_double_scene2_16x8_1samples_3bounces_8threadsPerBlockRow.ppm"
    assert os.listdir(tmp_path) == [name]
    got, _ = ppm.read_ppm(str(tmp_path / name))
    want = fk.render_f64(t_build(2, device="cpu"),
                         TCam.reference_default(), 16, 8, 1, 3)
    np.testing.assert_array_equal(got, ppm.quantize(want.numpy()))


def test_f64_inputs_from_numpy_round_trip(tiny_scene, default_camera):
    from raytracingincuda_tpu.ops.df64_trace import (initialize_f64 as
                                                     jinit_f64,
                                                     pack_scene_matrix_df64)

    hi, lo = pack_scene_matrix_df64(tiny_scene)
    rows = jinit_f64(default_camera, W, H)
    sm, row = f64_inputs_from_numpy(hi, lo, rows, device="cpu")
    scene, cam = _carried(tiny_scene, default_camera)
    assert torch.equal(sm, rk.pack_scene_matrix(scene))
    own = initialize_f64(cam, W, H)
    assert row.dtype == torch.float64 and row.shape == (24,)
    # JAX's hi word is the port's row rounded to f32; hi + lo keeps ~48 bits
    np.testing.assert_array_equal(rows[0], own.numpy().astype(np.float32))
    np.testing.assert_allclose(row.numpy(), own.numpy(), rtol=2.0 ** -46,
                               atol=0.0)
    bad = np.asarray(lo).copy()
    bad[0, 0] = 1e-9
    with pytest.raises(ValueError, match="lo words"):
        f64_inputs_from_numpy(hi, bad, rows, device="cpu")
    with pytest.raises(ValueError):
        f64_inputs_from_numpy(hi, lo, rows[:1], device="cpu")


# The kernel's scenes on the card: group_scenes' scenes, and scene 1 cut to
# or padded (inactive rows) to the two-level rule's edges: (scene, slots)
CARD_SCENES = {"cover": ("cover", None), "tie": ("tie", None),
               "random2000": ("random2000", None), "slots31": ("cover", 31),
               "slots32": ("cover", 32), "slots2049": ("random2000", 2049)}


def _card_inputs(name, dev, w=64, h=40):
    from group_scenes import scene_named

    base, slots = CARD_SCENES[name]
    ids, ii, jj, sm, row = fk.f64_inputs(scene_named(base, dev),
                                         TCam.reference_default(), w, h)
    if slots is not None:
        pad = torch.zeros((max(slots - sm.shape[0], 0), sm.shape[1]),
                          device=dev)
        sm = torch.cat([sm[:slots], pad]).contiguous()
    return ids, ii, jj, sm, row


def test_plain_count_mode_follows_the_rule():
    """The count mode's plain version: a lane's segments are the waves it
    traces in (two samples take two at least), a warp's issues its longest
    lane's; in two levels each issue tests the large entries and GROUP slots
    an opened group; in one level (layout 'hbm', 31 slots) every slot."""
    for name, layout in (("cover", "vmem"), ("cover", "hbm"),
                         ("slots31", "vmem")):
        inputs = _card_inputs(name, "cpu", 32, 8)
        n = inputs[3].shape[0]
        seg, issues, opened, tests = fk.f64_counts_reference(
            *inputs, samples=2, max_depth=6, layout=layout)
        assert issues.shape == (inputs[0].shape[0] // 32,)
        assert torch.equal(issues.float(), seg.view(-1, 32).amax(1))
        assert bool((seg >= 2).all())
        if gs.uses_groups(n, layout):
            t = gs.unpack(gs.group_table_reference(
                inputs[3], inputs[4].float()[None]), n)
            assert bool((opened > 0).any())
            assert torch.equal(tests, issues * t.n_large + opened * gs.GROUP)
            assert bool((tests < issues * n).all())
        else:
            assert bool((opened == 0).all())
            assert torch.equal(tests, issues * n)


@pytest.mark.cuda
@pytest.mark.parametrize("name,layout", [
    ("cover", "vmem"), ("cover", "hbm"), ("tie", "vmem"),
    ("random2000", "vmem"), ("slots31", "vmem"), ("slots32", "vmem"),
    ("slots2049", "vmem")])
def test_kernel_equals_plain_version_on_card(cuda, name, layout,
                                             monkeypatch):
    """Bit for bit against the plain version, on the card and the CPU, and
    from run to run; the launch scans as the rule says (two levels, after
    a group table's launch, from 2 x GROUP to MAX_SLOTS slots in layout
    'vmem'), and equals the same launch made one-level."""
    from group_scenes import one_level

    inputs = _card_inputs(name, cuda)
    two = gs.uses_groups(inputs[3].shape[0], layout)
    kw = dict(samples=2, max_depth=10, layout=layout)
    keys = ("launch.f64_render", "launch.group_table", "scan.two_level",
            "scan.one_level")
    before = {k: trace.counts().get(k, 0) for k in keys}
    got = fk.f64_kernel(*inputs, **kw)
    torch.cuda.synchronize()
    rise = {k: trace.counts().get(k, 0) - before[k] for k in keys}
    assert rise == {"launch.f64_render": 1, "launch.group_table": int(two),
                    "scan.two_level": int(two),
                    "scan.one_level": int(not two)}, rise
    assert got.dtype == torch.float64
    assert torch.equal(got, fk.f64_reference(*inputs, **kw))
    assert torch.equal(got, fk.f64_kernel(*inputs, **kw))
    cpu = fk.f64_reference(*(t.cpu() for t in inputs), **kw)
    assert torch.equal(got.cpu(), cpu)
    one_level(monkeypatch)
    assert torch.equal(got, fk.f64_kernel(*inputs, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("name,layout", [
    ("cover", "vmem"), ("cover", "hbm"), ("tie", "vmem")])
def test_count_mode_equals_plain_count_on_card(cuda, name, layout):
    """The count mode's segments per lane and issues, groups opened and
    slot tests per warp equal the plain count's (the double walk's vote wave by wave in layout
    'vmem'; every slot an issue in 'hbm')."""
    inputs = _card_inputs(name, cuda)
    kw = dict(samples=4, max_depth=12, layout=layout)
    got = fk.f64_counts(*inputs, **kw)
    want = fk.f64_counts_reference(*inputs, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    assert bool((got[2] > 0).any()) == (layout == "vmem")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vmem", "hbm"])
def test_kernel_at_offset_equals_plain_version_on_card(cuda, layout):
    """A window at ``sample_offset`` 5: bit for bit against the plain
    version, from run to run, and not the window at 0."""
    s = t_build(1, device=cuda)
    inputs = fk.f64_inputs(s, TCam.reference_default(), 64, 40)
    kw = dict(samples=4, max_depth=8, layout=layout)
    got = fk.f64_kernel(*inputs, sample_offset=5, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.f64_reference(*inputs, sample_offset=5, **kw))
    assert torch.equal(got, fk.f64_kernel(*inputs, sample_offset=5, **kw))
    assert not torch.equal(got, fk.f64_kernel(*inputs, **kw))
    assert torch.equal(fk.f64_kernel(*inputs, sample_offset=0, **kw),
                       fk.f64_kernel(*inputs, **kw))


def _glass(scene):
    """Every sphere but the ground dielectric: long paths."""
    mat = scene.mat_type.clone()
    mat[1:] = DIELECTRIC
    ior = torch.full_like(scene.params.ior, 1.5)
    return Scene(scene.params._replace(ior=ior), mat, scene.active)


# (scene, width, height, spp, depth): every path ends at bounce 0; one
# sample; 16 samples at 640 lanes; long paths through glass
EDGE_CASES = {"depth1": (1, 64, 40, 4, 1), "spp1": (1, 64, 40, 1, 25),
              "spp16": (1, 40, 16, 16, 8), "glass": (0, 48, 32, 4, 50)}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vmem", "hbm"])
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_kernel_edge_cases_on_card(cuda, case, layout):
    sid, w, h, spp, depth = EDGE_CASES[case]
    s = _glass(t_build(1, device=cuda)) if sid == 0 else t_build(sid,
                                                                 device=cuda)
    inputs = fk.f64_inputs(s, TCam.reference_default(), w, h)
    kw = dict(samples=spp, max_depth=depth, layout=layout)
    got = fk.f64_kernel(*inputs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.f64_reference(*inputs, **kw))
    assert torch.equal(got, fk.f64_kernel(*inputs, **kw))
