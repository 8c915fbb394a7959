"""Renderer factory: config + device -> ``renderer(scene, cam_cfg) -> image``.

``impl='kernel'`` is the main path, the counterpart of the JAX package's
``make_renderer(impl='pallas')``: the regeneration kernel renders the
pixels in raster order. The JAX renderer orders them by a difficulty
prepass first; on the card, where raster neighbours already share their
traced depth, that order made the kernel slower (``PERF.md``), so this
renderer takes none. ``impl='stream'`` (and ``impl='kernel'`` with
``layout='packed'``, the texture-path analog, which routes there as in
JAX) renders through the stream kernel (``ops/stream_kernel.py``): a
prepared scene of any size, walked in culled sphere blocks.
``impl='adaptive'`` renders with per-pixel sample budgets
(``ops/adaptive.py``) on the regen kernel, or on the stream kernel above
4096 slots, whatever the layout. ``impl='oracle'`` runs the plain
PyTorch tracer and ignores the layout. ``dtype='float64'`` renders in
double through the f64 kernel (``ops/f64_kernel.py``, ``impl='kernel'``)
or the f64 oracle (``tracer.render(dtype=torch.float64)``,
``impl='oracle'``, with either estimator and ``legacy_sky``).
``_route`` makes that choice for both factories here: ``make_renderer``
and ``make_sum_renderer``, whose raw sums over a window of samples are
``utils.checkpoint.render_incremental``'s rounds.

``n_devices``: the launched world of one process per device
(``parallel/mesh.py``; 0 takes it, 1 without a launcher). Each rank
renders its slice of the pixels and every rank returns the whole image,
the same bits as one process renders. Any other value than the world
raises, where JAX clamps to the devices it has; the f64 kernel renders on
one device and raises under a larger world, where JAX notes it and
renders on one. The f64 oracle shards, as JAX's does.

Nothing falls back: a CUDA device without CUDA raises, and the kernel
path on a CPU device runs the kernel's plain version by design (the
wrapper picks it for CPU tensors only).
"""
from __future__ import annotations

from typing import Callable

import torch

from .config import RenderConfig
from .device import resolve_device
from .models.camera import CameraConfig, initialize
from .models.scene import Scene, _round_up, param_leaves
from .ops import f64_kernel, render_kernel, stream_kernel, tracer
from .parallel import mesh as meshlib
from .utils import trace


def _leaf_key(scene: Scene, cam_cfg: CameraConfig) -> tuple:
    """Shapes and dtypes of every tensor leaf: the prepass order cache key."""
    leaves = [*scene.params.center, scene.params.radius, *scene.params.albedo,
              scene.params.fuzz, scene.params.ior, scene.mat_type, scene.active,
              cam_cfg.vfov, *cam_cfg.lookfrom, *cam_cfg.lookat, *cam_cfg.vup,
              cam_cfg.defocus_angle, cam_cfg.focus_dist]
    return tuple((tuple(x.shape), str(x.dtype)) for x in leaves)


def _identity_cache():
    """One entry keyed by the IDENTITY of a scene's tensors, holding them
    (a bare id() could be reused by a new object): ``get(scene, build)``
    returns the cached value iff every tensor is the same object as last
    time, else builds anew."""
    slot = {"leaves": None, "value": None}

    def get(scene: Scene, build):
        leaves = [*param_leaves(scene.params), scene.mat_type, scene.active]
        old = slot["leaves"]
        if old is None or any(a is not b for a, b in zip(old, leaves)):
            slot["value"] = build()
            slot["leaves"] = leaves
        return slot["value"]

    return get


# Scenes up to this many slots ride one block (the whole scene), and get
# the difficulty order from the regen kernel's prepass (layout 'vmem').
_ONE_BLOCK_SLOTS = 4096


def _stream_preparer(cfg: RenderConfig) -> Callable:
    """``get(scene, cam_cfg=None) -> StreamScene`` by the JAX package's
    rules: a scene of at most 4096 slots is one block of round_up(slots,
    256) rows, unpaired; a larger one is blocked by ``cfg.stream_block``.
    The preparation is cached by the scene's identity; the bounds are
    reordered front to back from the first camera given."""
    prepared = _identity_cache()

    def build(scene):
        if scene.num_slots <= _ONE_BLOCK_SLOTS:
            return {"stream": stream_kernel.prepare_stream_scene(
                scene, block=_round_up(scene.num_slots, 256),
                pad_pairs=False)}
        return {"stream": stream_kernel.prepare_stream_scene(
            scene, block=cfg.stream_block)}

    def get(scene, cam_cfg=None):
        ent = prepared(scene, lambda: build(scene))
        if cam_cfg is not None and "camdist" not in ent:
            ent["camdist"] = True
            ent["stream"] = stream_kernel.reorder_front_to_back(
                ent["stream"], initialize(cam_cfg, cfg.width,
                                          cfg.height).center)
        return ent["stream"]

    return get


def _stream_renderer(cfg: RenderConfig, check, mesh) -> Callable:
    """``impl='stream'``: the stream kernel on ``_stream_preparer``'s
    stream (``renderer.prepare`` runs the preparation ahead); one-block
    scenes get the difficulty order at >= 8 spp and > 4 bounces."""
    if cfg.legacy_sky:
        raise ValueError("impl=stream has no legacy_sky variant")
    stream_of = _stream_preparer(cfg)
    order_cache: dict = {}

    def renderer(scene, cam_cfg):
        check(scene)
        order = None
        if scene.num_slots <= _ONE_BLOCK_SLOTS:
            order = _prepass_order(cfg, scene, cam_cfg, order_cache)
        return stream_kernel.render_stream(
            stream_of(scene, cam_cfg), cam_cfg, cfg.width, cfg.height,
            cfg.samples, cfg.bounces, seed=cfg.seed, rr_start=cfg.rr_start,
            pixel_order=order, mesh=mesh)

    renderer.prepare = stream_of
    return renderer


def _adaptive_renderer(cfg: RenderConfig, check, mesh) -> Callable:
    """``impl='adaptive'`` (``ops/adaptive.py``): a scene of at most 4096
    slots renders every phase on the regen kernel with the scene staged
    (layout ``vmem``); a larger one on the stream kernel, over the stream
    ``_stream_preparer`` builds (blocks of ``cfg.stream_block``, cached by
    the scene's identity, front to back from the first camera), whose
    image equals the brute-force one but at exact ties between blocks.
    ``renderer.prepare`` runs that preparation ahead."""
    from .ops.adaptive import render_adaptive

    stream_of = _stream_preparer(cfg)

    def renderer(scene, cam_cfg):
        check(scene)
        stream = None
        if scene.num_slots > _ONE_BLOCK_SLOTS:
            stream = stream_of(scene, cam_cfg)
        return render_adaptive(
            scene, cam_cfg, cfg.width, cfg.height, cfg.bounces,
            base_spp=cfg.samples, max_spp=cfg.effective_max_samples,
            tol=cfg.adaptive_tol, seed=cfg.seed, legacy_sky=cfg.legacy_sky,
            rr_start=cfg.rr_start, rounds=cfg.adaptive_rounds,
            stream=stream, mesh=mesh).image

    def prepare(scene):
        if scene.num_slots > _ONE_BLOCK_SLOTS:
            stream_of(scene)

    renderer.prepare = prepare
    return renderer


def _prepass_order(cfg: RenderConfig, scene: Scene, cam_cfg: CameraConfig,
                   order_cache: dict):
    """The f32 difficulty order at >= 8 spp and > 4 bounces (else None),
    from the regen kernel's prepass with the scene staged (layout
    ``vmem``), cached by leaf shapes: any permutation gives the same
    image, so a different same-shaped scene gets a stale but valid order,
    which changes speed only."""
    if not (cfg.samples >= 8 and cfg.bounces > 4):
        return None
    key = _leaf_key(scene, cam_cfg)
    order = order_cache.get(key)
    if order is None:
        pd, ps = min(8, cfg.bounces), min(6, cfg.samples)
        seg = render_kernel.measure_difficulty(
            scene, cam_cfg, cfg.width, cfg.height, pd, ps, seed=cfg.seed,
            layout="vmem")
        order = render_kernel.difficulty_order(seg, pd, ps)
        order_cache.clear()
        order_cache[key] = order
    return order


def make_f64_renderer(cfg: RenderConfig, check) -> Callable:
    """``dtype='float64'``: the counterpart of the JAX
    ``make_df64_renderer``. Returns ``renderer(scene, cam_cfg) -> (H, W,
    3)`` float64 (JAX returns (H, W, 3, 2) f32 hi/lo pairs). The lanes
    run in raster order, as kernel 1's renderer runs them: with the f64
    kernel's regenerating loop the f32 prepass's difficulty order made
    every render slower on the card (raster neighbours share their
    depth), and an order changes speed only. The packed scene matrix is
    cached by the scene's identity; ``prepare`` packs it ahead."""
    if cfg.dtype != "float64":
        raise ValueError(f"make_f64_renderer renders dtype float64, the "
                         f"config says {cfg.dtype}")
    packed = _identity_cache()

    def renderer(scene, cam_cfg):
        check(scene)
        return f64_kernel.render_f64(
            scene, cam_cfg, cfg.width, cfg.height, cfg.samples, cfg.bounces,
            seed=cfg.seed, layout=cfg.layout, scene_mat=prepare(scene))

    def prepare(scene):
        check(scene)
        return packed(scene, lambda: render_kernel.pack_scene_matrix(scene))

    renderer.prepare = prepare
    return renderer


def _route(cfg: RenderConfig) -> str:
    """The renderer that serves ``cfg``, by the JAX package's rules:
    'oracle' (the plain tracer in the config's dtype, whatever the
    layout), 'f64' (the f64 kernel), 'adaptive' (tested before the packed
    layout: the adaptive renderer picks its kernel by slot count, whatever
    the layout), 'stream' (``impl='stream'``, or ``impl='kernel'`` with
    ``layout='packed'``) or 'regen' (kernel 1)."""
    if cfg.impl == "oracle":
        return "oracle"
    if cfg.dtype == "float64":
        # RenderConfig allows float64 with impl kernel or oracle only
        return "f64"
    if cfg.impl == "adaptive":
        return "adaptive"
    if cfg.impl == "stream" or cfg.layout == "packed":
        return "stream"
    return "regen"


def _scene_check(device) -> Callable:
    """``check(scene)``: raises unless the scene is on ``device``'s type;
    a CUDA device without CUDA raises here (``device.resolve_device``)."""
    device = resolve_device(device)

    def check(scene: Scene):
        if scene.mat_type.device.type != device.type:
            raise ValueError(f"scene is on {scene.mat_type.device}, the "
                             f"renderer on {device}")

    return check


def make_renderer(cfg: RenderConfig, device, n_devices: int = 0) -> Callable:
    """Return ``renderer(scene, cam_cfg) -> (H, W, 3)`` on ``device``: f32,
    or float64 for ``dtype='float64'``.

    The scene must already be on ``device`` (``build_scene(...,
    device=...)``); the camera config is host data. ``n_devices``: 0 (the
    launched world) or the world's size; under a world of more than one
    rank each rank renders its slice of the pixels
    (``parallel.mesh.make_mesh``) and every rank gets the whole image.
    The construction is span ``rt.make_renderer``, each render
    ``rt.render`` (``utils/trace.py``)."""
    with trace.span("rt.make_renderer"):
        renderer = _make_renderer(cfg, device, n_devices)
    return trace.spanned("rt.render")(renderer)


def _make_renderer(cfg: RenderConfig, device, n_devices: int) -> Callable:
    check = _scene_check(device)
    mesh = meshlib.make_mesh(n_devices, device=torch.device(device))
    mesh = mesh if mesh.world > 1 else None
    route = _route(cfg)

    if route == "oracle":
        dtype = cfg.torch_dtype

        def oracle_renderer(scene, cam_cfg):
            check(scene)
            return tracer.render(
                scene, cam_cfg, cfg.width, cfg.height, cfg.samples,
                cfg.bounces, seed=cfg.seed, dtype=dtype,
                chunk_pixels=cfg.effective_chunk_pixels,
                legacy_sky=cfg.legacy_sky, rr_start=cfg.rr_start, mesh=mesh,
            )

        return oracle_renderer

    if route == "f64":
        if mesh is not None:
            raise ValueError(
                f"the f64 kernel renders on one device, the launched world "
                f"has {mesh.world} ranks: run one process, or impl='oracle' "
                f"(the f64 oracle shards)")
        return make_f64_renderer(cfg, check)

    if route == "adaptive":
        return _adaptive_renderer(cfg, check, mesh)

    if route == "stream":
        return _stream_renderer(cfg, check, mesh)

    def renderer(scene, cam_cfg):
        check(scene)
        return render_kernel.render_kernel(
            scene, cam_cfg, cfg.width, cfg.height, cfg.samples, cfg.bounces,
            seed=cfg.seed, layout=cfg.layout, legacy_sky=cfg.legacy_sky,
            rr_start=cfg.rr_start, mesh=mesh)

    return renderer


def make_sum_renderer(cfg: RenderConfig, device) -> Callable:
    """Return ``render_sum(scene, cam_cfg, n, sample_offset) -> (H, W,
    3)``: each pixel's raw sum of samples ``[sample_offset, sample_offset
    + n)`` on one device, on ``make_renderer``'s route for ``cfg``. These
    are ``utils.checkpoint.render_incremental``'s rounds.

    The oracle sums in the config's dtype; kernels 1 and 4 sum in f32,
    and the stream kernel refuses ``legacy_sky`` as ``make_renderer``
    does. ``impl='adaptive'`` sums uniform samples (a budget does not
    split into rounds) on the kernel its renderer takes at the scene's
    slot count. A float64 config with ``impl='kernel'`` sums in double on
    the f64 kernel, over the f32 scene and the float64 camera row that
    ``make_f64_renderer`` renders from."""
    route = _route(cfg)
    if route == "stream" and cfg.legacy_sky:
        raise ValueError("impl=stream has no legacy_sky variant")
    check = _scene_check(device)
    stream_of = _stream_preparer(cfg)
    dtype = cfg.torch_dtype

    def render_sum(scene, cam_cfg, n, sample_offset):
        check(scene)
        if route == "f64":
            return f64_kernel.render_f64(
                scene, cam_cfg, cfg.width, cfg.height, n, cfg.bounces,
                seed=cfg.seed, layout=cfg.layout,
                sample_offset=sample_offset, accumulate_only=True)
        kw = dict(seed=cfg.seed, rr_start=cfg.rr_start,
                  sample_offset=sample_offset, accumulate_only=True)
        if route == "oracle":
            return tracer.render(
                scene, cam_cfg, cfg.width, cfg.height, n, cfg.bounces,
                dtype=dtype, chunk_pixels=cfg.chunk_pixels,
                legacy_sky=cfg.legacy_sky, **kw)
        big = scene.num_slots > _ONE_BLOCK_SLOTS
        if route == "stream" or (route == "adaptive" and big):
            if cfg.legacy_sky:
                raise ValueError("streamed adaptive has no legacy_sky")
            return stream_kernel.render_stream(
                stream_of(scene, cam_cfg), cam_cfg, cfg.width, cfg.height,
                n, cfg.bounces, **kw)
        return render_kernel.render_kernel(
            scene, cam_cfg, cfg.width, cfg.height, n, cfg.bounces,
            layout="vmem" if route == "adaptive" else cfg.layout,
            legacy_sky=cfg.legacy_sky, **kw)

    return render_sum
