"""Renderer factory: config + device -> ``renderer(scene, cam_cfg) -> image``.

``impl='kernel'`` is the main path, the counterpart of the JAX package's
``make_renderer(impl='pallas')``: the regeneration kernel renders the
pixels in raster order. The JAX renderer orders them by a difficulty
prepass first; on the card, where raster neighbours already share their
traced depth, that order made the kernel slower (``PERF.md``), so this
renderer takes none. ``impl='stream'`` (and ``layout='packed'``, the texture-path
analog, which routes there as in JAX) renders through the stream kernel
(``ops/stream_kernel.py``): a prepared scene of any size, walked in
culled sphere blocks. ``impl='oracle'`` runs the plain PyTorch tracer.
``dtype='float64'`` (``impl='kernel'`` only) renders in double through
the f64 kernel (``ops/f64_kernel.py``), ordered by the f32 prepass.

Nothing falls back: a CUDA device without CUDA raises, and the kernel
path on a CPU device runs the kernel's plain version by design (the
wrapper picks it for CPU tensors only).
"""
from __future__ import annotations

from typing import Callable

import torch

from .config import RenderConfig
from .models.camera import CameraConfig, initialize
from .models.scene import Scene, _round_up, param_leaves
from .ops import f64_kernel, render_kernel, stream_kernel, tracer


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


def _stream_renderer(cfg: RenderConfig, check) -> Callable:
    """``impl='stream'``: the JAX package's rules. A scene of at most 4096
    slots is one block of round_up(slots, 256) rows, unpaired; a larger
    one is blocked by ``cfg.stream_block``. The preparation is cached by
    the scene's identity (``renderer.prepare`` runs it ahead); the bounds
    are reordered front to back at the first render; one-block scenes get
    the difficulty order at >= 8 spp and > 4 bounces."""
    if cfg.legacy_sky:
        raise ValueError("impl=stream has no legacy_sky variant")
    prepared = _identity_cache()
    order_cache: dict = {}

    def build(scene):
        if scene.num_slots <= _ONE_BLOCK_SLOTS:
            return {"stream": stream_kernel.prepare_stream_scene(
                scene, block=_round_up(scene.num_slots, 256),
                pad_pairs=False)}
        return {"stream": stream_kernel.prepare_stream_scene(
            scene, block=cfg.stream_block)}

    def renderer(scene, cam_cfg):
        check(scene)
        ent = prepared(scene, lambda: build(scene))
        if "camdist" not in ent:
            ent["camdist"] = True
            ent["stream"] = stream_kernel.reorder_front_to_back(
                ent["stream"], initialize(cam_cfg, cfg.width,
                                          cfg.height).center)
        order = None
        if scene.num_slots <= _ONE_BLOCK_SLOTS:
            order = _prepass_order(cfg, scene, cam_cfg, order_cache, "vmem")
        return stream_kernel.render_stream(
            ent["stream"], cam_cfg, cfg.width, cfg.height, cfg.samples,
            cfg.bounces, seed=cfg.seed, rr_start=cfg.rr_start,
            pixel_order=order)

    def prepare(scene):
        prepared(scene, lambda: build(scene))

    renderer.prepare = prepare
    return renderer


def _prepass_order(cfg: RenderConfig, scene: Scene, cam_cfg: CameraConfig,
                   order_cache: dict, layout=None):
    """The f32 difficulty order at >= 8 spp and > 4 bounces (else None),
    from the regen kernel's prepass in ``layout`` (``cfg.layout`` by
    default), cached by leaf shapes: any permutation gives the same
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
            layout=layout or cfg.layout)
        order = render_kernel.difficulty_order(seg, pd, ps)
        order_cache.clear()
        order_cache[key] = order
    return order


def make_f64_renderer(cfg: RenderConfig, check) -> Callable:
    """``dtype='float64'``: the counterpart of the JAX
    ``make_df64_renderer``. Returns ``renderer(scene, cam_cfg) -> (H, W,
    3)`` float64 (JAX returns (H, W, 3, 2) f32 hi/lo pairs). At >= 8 spp
    and > 4 bounces the lanes take the difficulty order of the f32
    prepass (kernel 1, ``cfg.layout``), cached by the scene's shapes:
    the order changes speed only. The packed scene matrix is cached by
    the scene's identity; ``prepare`` packs it ahead."""
    if cfg.dtype != "float64":
        raise ValueError(f"make_f64_renderer renders dtype float64, the "
                         f"config says {cfg.dtype}")
    packed = _identity_cache()
    order_cache: dict = {}

    def renderer(scene, cam_cfg):
        check(scene)
        return f64_kernel.render_f64(
            scene, cam_cfg, cfg.width, cfg.height, cfg.samples, cfg.bounces,
            seed=cfg.seed, layout=cfg.layout,
            pixel_order=_prepass_order(cfg, scene, cam_cfg, order_cache),
            scene_mat=prepare(scene))

    def prepare(scene):
        check(scene)
        return packed(scene, lambda: render_kernel.pack_scene_matrix(scene))

    renderer.prepare = prepare
    return renderer


def make_renderer(cfg: RenderConfig, device) -> Callable:
    """Return ``renderer(scene, cam_cfg) -> (H, W, 3)`` on ``device``: f32,
    or float64 for ``dtype='float64'`` (``make_f64_renderer``).

    The scene must already be on ``device`` (``build_scene(...,
    device=...)``); the camera config is host data."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False: there is no CUDA device here")

    def check(scene: Scene):
        if scene.mat_type.device.type != device.type:
            raise ValueError(f"scene is on {scene.mat_type.device}, the "
                             f"renderer on {device}")

    if cfg.dtype == "float64":
        # RenderConfig allows float64 with impl='kernel' only
        return make_f64_renderer(cfg, check)

    if cfg.impl == "oracle":
        def oracle_renderer(scene, cam_cfg):
            check(scene)
            return tracer.render(
                scene, cam_cfg, cfg.width, cfg.height, cfg.samples,
                cfg.bounces, seed=cfg.seed,
                chunk_pixels=cfg.effective_chunk_pixels,
                legacy_sky=cfg.legacy_sky, rr_start=cfg.rr_start,
            )

        return oracle_renderer

    if cfg.impl == "stream" or cfg.layout == "packed":
        return _stream_renderer(cfg, check)

    def renderer(scene, cam_cfg):
        check(scene)
        return render_kernel.render_kernel(
            scene, cam_cfg, cfg.width, cfg.height, cfg.samples, cfg.bounces,
            seed=cfg.seed, layout=cfg.layout, legacy_sky=cfg.legacy_sky,
            rr_start=cfg.rr_start)

    return renderer
