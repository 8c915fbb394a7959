"""The route matrix: the same config through the port and the JAX package.

Every ``make_renderer`` route (impl x layout x estimator, at float32 and
float64), every ``render_incremental`` route (the same grid) and the
CLI's grid of ``--impl/--layout/--dtype/--rr_start/--legacy_sky`` run
on the CPU at scene 2, 16x10, 4 spp, 4 bounces. The port's
``impl='kernel'`` is JAX's ``'pallas'``. Each case ends in one of three
outcomes:

  (a) both render: equal shapes; float32 images within 1e-4 and through
      the 8-bit golden gate of ``utils/ppm.py`` (at most 1 level off,
      more than 99% exact); float64 images within 1e-6;
  (b) both raise, with any exception;
  (c) the case is one of ``DIVERGENCES``, the divergences kept on purpose
      that ROADMAP.md's Queue 3 records: the port raises there and JAX
      renders (the test checks both, so an entry that stops diverging
      fails).

Measured at these shapes: float32 within 8.51e-6 on every route; float64
within 9.14e-14 on the f64 oracle, 2.85e-8 on the f64 kernel (its scene
is float32, JAX's float64), and from ``render_incremental`` (JAX casts
each round to f32, the port keeps the sum in double) 5.60e-8 on the f64
oracle and 5.96e-8 on the f64 kernel, whose rounds are windows of
samples at a ``sample_offset``.

JAX renders each case's own config: on the CPU its 'pallas' is its
oracle, and 'pallas' with 'packed' its stream kernel in interpret mode.
A JAX image is cached by the program JAX traces for the config where its
renderer is one jitted program, else by the config, so the file compiles
each JAX program once; the port renders every case. JAX runs on one device
(``n_devices=1``), as the port's renderer does here, and with x64 on only
inside each float64 call, since xdist reuses a worker across files.
Scenes and cameras are built as each CLI builds them: in float64 for the
f64 oracle (JAX's CPU route builds every float64 scene so), in float32
otherwise. ``chunk_pixels`` sizes the oracles' pixel chunks and changes
no value; 256 keeps the oracles from padding to 8192 lanes.
"""
import functools
import os

import numpy as np
import pytest
import torch

from raytracingincuda_torch import cli
from raytracingincuda_torch.config import RenderConfig
from raytracingincuda_torch.models.camera import CameraConfig
from raytracingincuda_torch.models.scene import build_scene
from raytracingincuda_torch.render_api import make_renderer
from raytracingincuda_torch.utils import checkpoint, ppm

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

W, H, SPP, DEPTH, CHUNK = 16, 10, 4, 4, 256
F32_ATOL, F64_ATOL = 1e-4, 1e-6
IMPLS = ("oracle", "kernel", "adaptive", "stream")
LAYOUTS = ("vmem", "hbm", "packed")
ESTIMATORS = {"parity": {}, "rr2": {"rr_start": 2},
              "legacy_sky": {"legacy_sky": True}}
DTYPES = ("float32", "float64")

# (c): name -> (which cases, whether the test runs JAX's side, what each
# package does). The names are ROADMAP.md Queue 3's bullets under
# "Divergences kept on purpose".
DIVERGENCES = {
    "f64 adaptive": (
        lambda kind, impl, layout, est, dtype: (
            kind != "incremental" and dtype == "float64"
            and impl == "adaptive"),
        False,  # JAX's side takes 7 s a case here
        "the port's config refuses float64 outside impl kernel and "
        "oracle; JAX's CPU route renders its f32 interpret-mode kernels "
        "under the f64 label (its accelerator route raises)."),
    "f64 pallas on the CPU": (
        lambda kind, impl, layout, est, dtype: (
            dtype == "float64" and impl == "kernel" and (
                est != "parity" and layout != "packed"
                if kind != "incremental"
                else est != "parity" or layout == "packed")),
        True,
        "the port's f64 kernel keeps the JAX df64 kernel's scope (parity, "
        "no legacy_sky, layout vmem or hbm) and refuses the rest, as JAX "
        "does on an accelerator, in make_renderer and in "
        "render_incremental's rounds; JAX on the CPU renders its f64 "
        "oracle instead ('pallas' falls back to it), and JAX's "
        "render_incremental renders every round on its oracle whatever "
        "the impl and layout (its make_renderer raises at packed, as the "
        "port's does)."),
    "f64 render_incremental off the oracle": (
        lambda kind, impl, layout, est, dtype: (
            kind == "incremental" and dtype == "float64"
            and impl in ("adaptive", "stream")),
        True,
        "the port's config refuses float64 with impl adaptive or stream "
        "(they have no f64 path), in rounds as in make_renderer; JAX's "
        "render_incremental renders every round on its oracle whatever "
        "the impl."),
    "render_incremental on the stream kernel with legacy_sky": (
        lambda kind, impl, layout, est, dtype: (
            kind == "incremental" and dtype == "float32"
            and est == "legacy_sky"
            and (impl == "stream" or (impl == "kernel"
                                      and layout == "packed"))),
        True,
        "the port renders the rounds on make_renderer's route, the stream "
        "kernel, which has no legacy_sky variant (make_renderer raises "
        "there in both packages); JAX's render_incremental renders every "
        "round on its oracle."),
}


def _divergence(kind, impl, layout, est, dtype):
    named = [n for n, (hit, _, _) in DIVERGENCES.items()
             if hit(kind, impl, layout, est, dtype)]
    assert len(named) <= 1, named
    return named[0] if named else None


class _x64:
    """jax_enable_x64 on inside the block only (for float64)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        if self.on:
            import jax

            jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        if self.on:
            import jax

            jax.config.update("jax_enable_x64", False)


def _scene_dtype(impl, dtype):
    """The CLI's rule: the f64 oracle takes its scene in double."""
    return "float64" if dtype == "float64" and impl == "oracle" else "float32"


def _port_cfg(impl, layout, est, dtype):
    return RenderConfig(scene_id=2, width=W, height=H, samples=SPP,
                        bounces=DEPTH, impl=impl, layout=layout, dtype=dtype,
                        chunk_pixels=CHUNK, **ESTIMATORS[est])


def _port_inputs(scene_dtype):
    dt = getattr(torch, scene_dtype)
    return (build_scene(2, dtype=dt, device="cpu"),
            CameraConfig.reference_default(dtype=dt))


def _jax_inputs(dtype):
    """JAX's scene 2 and camera in ``dtype``, built once (inside the
    float64 cases' x64 block, where they are used)."""
    if dtype not in _JAX_INPUTS:
        import jax.numpy as jnp

        from raytracingincuda_tpu.models.camera import \
            CameraConfig as JaxCamera
        from raytracingincuda_tpu.models.scene import \
            build_scene as jax_scene

        dt = getattr(jnp, dtype)
        _JAX_INPUTS[dtype] = (jax_scene(2, dtype=dt),
                              JaxCamera.reference_default(dtype=dt))
    return _JAX_INPUTS[dtype]


def _jax_cfg(impl, layout, est, dtype):
    from raytracingincuda_tpu.config import RenderConfig as JaxConfig

    return JaxConfig(scene_id=2, width=W, height=H, samples=SPP,
                     bounces=DEPTH, impl="pallas" if impl == "kernel" else impl,
                     layout=layout, dtype=dtype, chunk_pixels=CHUNK,
                     **ESTIMATORS[est])


def _outcome(fn):
    try:
        return np.asarray(fn())
    except Exception as e:  # (b) counts any exception
        return e


_PORT: dict = {}
_JAX: dict = {}
_JAX_INPUTS: dict = {}


def _port_image(impl, layout, est, dtype):
    key = (impl, layout, est, dtype)
    if key not in _PORT:
        def run():
            cfg = _port_cfg(impl, layout, est, dtype)
            return make_renderer(cfg, "cpu")(
                *_port_inputs(_scene_dtype(impl, dtype))).numpy()
        _PORT[key] = _outcome(run)
    return _PORT[key]


def _jax_program(renderer, cfg):
    """What a JAX renderer runs: for a jitted renderer over one
    ``functools.partial`` (the oracle, and 'pallas' on the CPU, which
    falls back to it) that function with its static arguments, so configs
    that JAX renders with one program share its compile; for any other
    renderer (the stream and adaptive closures) its config."""
    cells = [c.cell_contents for c in getattr(
        getattr(renderer, "__wrapped__", None), "__closure__", None) or ()]
    if len(cells) == 1 and isinstance(cells[0], functools.partial):
        p = cells[0]
        return ("jit", p.func.__module__, p.func.__qualname__, repr(p.args),
                repr(sorted(p.keywords.items())))
    return ("config", repr(cfg))


def _jax_image(impl, layout, est, dtype):
    """JAX's ``make_renderer`` for the case's own config, each program
    rendered once (``_jax_program``)."""
    from raytracingincuda_tpu.render_api import make_renderer as jax_mr

    cfg = _jax_cfg(impl, layout, est, dtype)
    with _x64(dtype == "float64"):
        try:
            renderer = jax_mr(cfg, n_devices=1)
        except Exception as e:  # (b) counts any exception
            return e
        key = _jax_program(renderer, cfg)
        if key not in _JAX:
            _JAX[key] = _outcome(lambda: renderer(*_jax_inputs(dtype)))
    return _JAX[key]


def _assert_agree(got, want, dtype):
    assert got.shape == want.shape, (got.shape, want.shape)
    if dtype == "float64":
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    stats = ppm.diff_stats(got, ppm.quantize(want))
    assert ppm.passes_golden_gate(stats), stats


def _check_case(kind, case, port, jax_fn):
    """One case: (a), (b) or its named (c) entry."""
    name = _divergence(kind, *case)
    if name is not None:
        assert isinstance(port, Exception), (name, "the port renders")
        if DIVERGENCES[name][1]:
            want = jax_fn()
            assert not isinstance(want, Exception), (name, want)
        return
    want = jax_fn()
    if isinstance(port, Exception) or isinstance(want, Exception):
        assert (isinstance(port, Exception)
                and isinstance(want, Exception)), (port, want)
        return
    _assert_agree(port, want, case[-1])


CASES = [(i, lay, e, dt) for dt in DTYPES for i in IMPLS for lay in LAYOUTS
         for e in ESTIMATORS]
IDS = ["-".join(c) for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_make_renderer_route_matches_jax(case):
    _check_case("render", case, _port_image(*case), lambda: _jax_image(*case))


INCREMENTAL = CASES


@pytest.mark.parametrize("case", INCREMENTAL, ids=IDS)
def test_render_incremental_route_matches_jax(case):
    """The port in two rounds of 2 samples, on ``make_renderer``'s route
    (``render_api.make_sum_renderer``), its scene built as the CLI builds
    it, against JAX's ``render_incremental`` in one round of 4: the rounds
    add up to the single pass. JAX renders every round on its oracle in
    the config's dtype and reads neither ``impl`` nor ``layout``, so its
    image is keyed by dtype and estimator."""
    impl, layout, est, dtype = case

    def port():
        return checkpoint.render_incremental(
            *_port_inputs(_scene_dtype(impl, dtype)), _port_cfg(*case),
            samples_per_round=2)

    def jax():
        key = ("incremental", dtype, est)
        if key not in _JAX:
            from raytracingincuda_tpu.utils.checkpoint import (
                render_incremental)

            def run():
                with _x64(dtype == "float64"):
                    return render_incremental(*_jax_inputs(dtype),
                                              _jax_cfg(*case))
            _JAX[key] = _outcome(run)
        return _JAX[key]

    got = _outcome(port)
    if dtype == "float64" and not isinstance(got, Exception):
        assert got.dtype == np.float64     # the port keeps the sum in double
    # JAX casts each round to f32 and returns f32: the float64 bar holds
    _check_case("incremental", case, got, jax)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cli_route_matches_renderer(case, tmp_path, capsys):
    """``cli.main`` in-process: it raises where the port's renderer
    raises, and otherwise writes the config's file name with the bytes of
    the renderer's image (which the first test holds to JAX)."""
    impl, layout, est, dtype = case
    argv = ["--scene_id", "2", "--width", str(W), "--height", str(H),
            "--samples", str(SPP), "--bounces", str(DEPTH), "--device", "cpu",
            "--impl", impl, "--layout", layout, "--dtype", dtype,
            "--chunk_pixels", str(CHUNK), "--no-warmup",
            "--outdir", str(tmp_path)]
    argv += {"parity": [], "rr2": ["--rr_start", "2"],
             "legacy_sky": ["--legacy_sky"]}[est]
    want = _port_image(*case)
    if isinstance(want, Exception):
        with pytest.raises(type(want)):
            cli.main(argv)
        assert os.listdir(tmp_path) == []
        return
    assert cli.main(argv) == 0
    assert len(capsys.readouterr().out.strip().split(",")) == 2
    name = _port_cfg(*case).output_filename()
    assert os.listdir(tmp_path) == [name]
    ppm.write_ppm(str(tmp_path / "want.ppm"), want)
    assert (tmp_path / name).read_bytes() == (
        tmp_path / "want.ppm").read_bytes()


# -- the train entry points' limits -------------------------------------------

TRAIN_ENTRIES = ("make_mse_train", "make_train_step oracle",
                 "make_train_step kernel", "make_train_step fused",
                 "render_kernel_grads", "make_diff_render",
                 "make_stream_train fused", "make_stream_train two-program")
LIMIT_DEPTHS = (64, 65, 256, 257)
TW, TH = 8, 4
# (entry, max_depth) -> what each package does, where they differ on
# purpose (ROADMAP.md Queue 3, "Divergences kept on purpose").
DEPTH_DIVERGENCES = {
    (entry, 257): "JAX's train kernels (mse_train_pallas, "
    "render_pallas_grads, the stream gradient kernel and mse_train_stream) "
    "never call validate_stream_ids: at 257 bounces bounce 256's draws are "
    "the next sample's bounce 0's, with no error. The port raises with the "
    "sampler's message there, as JAX's renders and its make_diff_render do."
    for entry in ("make_mse_train", "make_train_step fused",
                  "render_kernel_grads", "make_stream_train fused")}
PIXEL_LIMIT_DIVERGENCE = (
    "Above kernel_io.MAX_LANES (715,827,840 lanes, the kernels' 32-bit "
    "(3, lanes) index products) the port raises on every route; JAX's "
    "render_pallas at pixels_per_lane=1 takes any image whose pixel ids "
    "fit its uint32 ids. Below that cap both packages take an image at "
    "one pixel a lane, and JAX's multi-pixel lanes and wave sweep (its "
    "make_renderer at 8 spp and more, its train kernels' default sweep) "
    "raise from 2^24 pixels on, where the port, which has neither, "
    "renders.")


def _port_train(entry, depth):
    from raytracingincuda_torch.ops import grad as tgrad
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import stream_kernel as sk
    from raytracingincuda_torch.ops import train_kernel as tk

    s, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    tgt = torch.zeros((TH, TW, 3))
    if entry == "make_mse_train":
        return tk.make_mse_train(s.mat_type, s.active, TW, TH, 1, depth)(
            s.params, cam, tgt)[0]
    if entry.startswith("make_train_step"):
        init_fn, step_fn = tgrad.make_train_step(
            TW, TH, 1, depth, impl=entry.split()[1])
        return step_fn(init_fn(s.params), cam, s.mat_type, s.active, tgt)[1]
    if entry == "render_kernel_grads":
        return tk.render_kernel_grads(s, cam, tgt + 1.0, TW, TH, 1, depth)[0]
    if entry == "make_diff_render":
        return rk.make_diff_render(s.mat_type, s.active, TW, TH, 1, depth)(
            s.params, cam)
    init_fn, step_fn = tgrad.make_stream_train(
        sk.prepare_stream_scene(s, block=32), TW, TH, 1, depth,
        fused=entry.endswith("fused"))
    return step_fn(init_fn(s.params), cam, s.mat_type, s.active, tgt)[1]


def _jax_train(entry, depth):
    """JAX's entry point traced with ``jax.eval_shape``: the depth checks
    are host code, so a refusal raises while tracing, and a function that
    traces takes the depth (nothing is compiled)."""
    import jax
    import jax.numpy as jnp

    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.models.scene import build_scene as jbuild
    from raytracingincuda_tpu.ops import grad as jg
    from raytracingincuda_tpu.ops import pallas_backward as pb
    from raytracingincuda_tpu.ops import pallas_kernel as pk
    from raytracingincuda_tpu.ops.pallas_stream import prepare_stream_scene

    s, cam = jbuild(2), JCam.reference_default()
    tgt = jnp.zeros((TH, TW, 3))
    if entry == "make_mse_train":
        f = pb.make_mse_train(s.mat_type, s.active, TW, TH, 1, depth,
                              interpret=True)
        return jax.eval_shape(f, s.params, cam, tgt)
    if entry.startswith("make_train_step"):
        impl = {"kernel": "pallas"}.get(entry.split()[1], entry.split()[1])
        init_fn, step_fn = jg.make_train_step(TW, TH, 1, depth, impl=impl,
                                              interpret=True)
        return jax.eval_shape(lambda p: step_fn(init_fn(p), cam, s.mat_type,
                                                s.active, tgt), s.params)
    if entry == "render_kernel_grads":
        return jax.eval_shape(lambda: pb.render_pallas_grads(
            s, cam, tgt + 1.0, TW, TH, 1, depth, interpret=True))
    if entry == "make_diff_render":
        f = pk.make_diff_render(s.mat_type, s.active, TW, TH, 1, depth,
                                interpret=True)
        return jax.eval_shape(f, s.params, cam)
    init_fn, step_fn = jg.make_stream_train(
        prepare_stream_scene(s, block=32), TW, TH, 1, depth,
        fused=entry.endswith("fused"), interpret=True)
    return jax.eval_shape(lambda p: step_fn(init_fn(p), cam, s.mat_type,
                                            s.active, tgt), s.params)


@pytest.mark.parametrize("entry", TRAIN_ENTRIES)
def test_train_entry_depth_limits(entry):
    """Each train entry point at max_depth 64, 65, 256 and 257 runs in
    both packages or raises in both (the port's refusal with the sampler's
    message), except the cases of DEPTH_DIVERGENCES, where JAX runs and
    the port raises. The port runs for real (8x4x1spp, scene 2, the plain
    versions) and its results are finite."""
    def outcome(fn):
        try:
            return fn()
        except Exception as e:  # a refusal of either kind counts
            return e

    for depth in LIMIT_DEPTHS:
        port = outcome(lambda: _port_train(entry, depth))
        jax_out = outcome(lambda: _jax_train(entry, depth))
        if isinstance(port, Exception):
            assert isinstance(port, ValueError), port
            assert "bounce counter field" in str(port), port
        else:
            assert bool(torch.isfinite(torch.as_tensor(port)).all())
        if (entry, depth) in DEPTH_DIVERGENCES:
            assert isinstance(port, Exception) and not isinstance(
                jax_out, Exception), (entry, depth, port, jax_out)
        else:
            assert (isinstance(port, Exception)
                    == isinstance(jax_out, Exception)), (entry, depth, port,
                                                         jax_out)
        assert isinstance(port, Exception) == (depth > 256), (entry, depth)


class _Reached(Exception):
    """Raised by a stand-in for a kernel dispatcher: the entry point got
    there with these lanes."""

    def __init__(self, ids, ii, jj):
        super().__init__(tuple(ids.shape))
        self.lanes = ids.shape[0]
        self.last = (int(ids[-1]), float(ii[-1]), float(jj[-1]))


def _port_large(entry, width, height, monkeypatch):
    """Run the port's entry point at width x height up to its kernel
    dispatcher, which raises ``_Reached`` with the lanes it was given
    (nothing renders). Returns that exception."""
    from raytracingincuda_torch.ops import f64_kernel as fk
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import stream_kernel as sk
    from raytracingincuda_torch.ops import stream_train_kernel as stk
    from raytracingincuda_torch.ops import train_kernel as tk

    def reached(ids, ii, jj, *args, **kw):
        raise _Reached(ids, ii, jj)

    for mod, name in ((rk, "_regen"), (sk, "_stream"), (fk, "_f64"),
                      (tk, "_grad"), (tk, "_fused"), (stk, "_fused")):
        monkeypatch.setattr(mod, name, reached)
    s, cam = build_scene(2, device="cpu"), CameraConfig.reference_default()
    cfg = dict(scene_id=2, width=width, height=height, samples=1, bounces=2)
    img = torch.zeros((height, width, 3))
    runs = {
        "render_pallas": lambda: make_renderer(RenderConfig(**cfg), "cpu")(
            s, cam),
        "render_pallas_stream": lambda: make_renderer(
            RenderConfig(**cfg, impl="stream"), "cpu")(s, cam),
        "render_pallas_df64": lambda: make_renderer(
            RenderConfig(**cfg, dtype="float64"), "cpu")(s, cam),
        "render_pallas_grads": lambda: tk.render_kernel_grads(
            s, cam, img, width, height, 1, 2),
        "mse_train_pallas": lambda: tk.make_mse_train(
            s.mat_type, s.active, width, height, 1, 2)(s.params, cam, img),
        "mse_train_stream": lambda: stk.mse_train_stream(
            sk.prepare_stream_scene(s, block=32), cam, img, width, height, 1,
            2),
    }
    with pytest.raises(_Reached) as got:
        runs[entry]()
    return got.value


def test_max_pixels_divergence(monkeypatch):
    """PIXEL_LIMIT_DIVERGENCE: at 4096x4104 (above 2^24 pixels) JAX's
    render_pallas, render_pallas_stream, render_pallas_df64,
    render_pallas_grads and mse_train_pallas (sweep 'sample') and
    mse_train_stream (sweep 'sample') trace (jax.eval_shape, nothing
    compiles) at pixels_per_lane=1 and raise at 16; each of the port's
    counterparts reaches its kernel with every lane, the last pixel's
    coordinates exact. Above MAX_LANES the port raises with the cap's
    name, before any lane exists."""
    import jax
    import jax.numpy as jnp

    from raytracingincuda_tpu.models.camera import CameraConfig as JCam
    from raytracingincuda_tpu.models.scene import build_scene as jbuild
    from raytracingincuda_tpu.ops import pallas_backward as pb
    from raytracingincuda_tpu.ops import pallas_df64 as pdf
    from raytracingincuda_tpu.ops import pallas_kernel as pk
    from raytracingincuda_tpu.ops import pallas_stream as ps
    from raytracingincuda_tpu.ops import pallas_stream_backward as psb
    from raytracingincuda_torch.ops import kernel_io as kio
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import train_kernel as tk

    w, h = 4096, 4104
    assert w * h > 1 << 24 and w * h % rk.PAD == 0
    js, jcam = jbuild(2), JCam.reference_default()
    jst = ps.prepare_stream_scene(js, block=32)
    rows = jax.ShapeDtypeStruct((h, w, 3), jnp.float32)

    def sweep(kpl):
        return "sample" if kpl == 1 else "wave"

    jax_entries = {
        "render_pallas": lambda kpl: jax.eval_shape(lambda: pk.render_pallas(
            js, jcam, w, h, 1, 2, interpret=True, pixels_per_lane=kpl)),
        "render_pallas_stream": lambda kpl: jax.eval_shape(
            lambda: ps.render_pallas_stream(jst, jcam, w, h, 1, 2,
                                            interpret=True,
                                            pixels_per_lane=kpl)),
        "render_pallas_df64": lambda kpl: jax.eval_shape(
            lambda: pdf.render_pallas_df64(js, jcam, w, h, 1, 2,
                                           interpret=True,
                                           pixels_per_lane=kpl)),
        "render_pallas_grads": lambda kpl: jax.eval_shape(
            lambda g: pb.render_pallas_grads(js, jcam, g, w, h, 1, 2,
                                             interpret=True, sweep=sweep(kpl),
                                             pixels_per_lane=kpl), rows),
        "mse_train_pallas": lambda kpl: jax.eval_shape(
            lambda t: pb.mse_train_pallas(js, jcam, t, w, h, 1, 2,
                                          interpret=True, sweep=sweep(kpl),
                                          pixels_per_lane=kpl), rows),
        "mse_train_stream": lambda kpl: jax.eval_shape(
            lambda t: psb.mse_train_stream(jst, jcam, t, w, h, 1, 2,
                                           interpret=True, sweep=sweep(kpl),
                                           pixels_per_lane=kpl), rows),
    }
    for entry, run in jax_entries.items():
        assert jax.tree_util.tree_leaves(run(1)), entry
        with pytest.raises(ValueError, match="16M"):
            run(16)
        got = _port_large(entry, w, h, monkeypatch)
        assert got.lanes == w * h, entry
        assert got.last == (w * h - 1, w - 1.0, h - 1.0), entry
    big = 32768
    assert big * big > kio.MAX_LANES
    for spp in (1, 8):
        with pytest.raises(ValueError, match="MAX_LANES"):
            make_renderer(RenderConfig(scene_id=2, width=big, height=big,
                                       samples=spp, bounces=2), "cpu")(
                build_scene(2, device="cpu"), CameraConfig.reference_default())
    with pytest.raises(ValueError, match="MAX_LANES"):
        tk.render_kernel_grads(build_scene(2, device="cpu"),
                               CameraConfig.reference_default(),
                               torch.zeros((1, 1, 3)), big, big, 1, 2)
