"""Differentiable rendering: gradients and the inverse-rendering train step.

The counterpart of ``raytracingincuda_tpu/ops/grad.py``. The image is
differentiable with respect to every continuous scene parameter (sphere
centres, radii, albedo, fuzz, IOR) and the camera, under the detached-
sampler convention: the random draws and every discrete decision (the
closest-hit winner, the material, the Schlick coin, metal absorption,
the Russian-roulette kill, liveness) are constants, and gradients flow
through the continuous quantities those decisions select.

"Training" is inverse rendering: fit scene parameters to a target image.
``make_train_step`` builds the step for three implementations, and
``make_stream_train`` for streamed scenes (``ops/stream_kernel.py``):

  * ``'oracle'``: autograd through the plain PyTorch tracer;
  * ``'kernel'``: the regen kernel forward and the gradient kernel
    backward (``render_kernel.make_diff_render``; the JAX ``'pallas'``);
  * ``'fused'``: the fused step kernel, render, loss and gradients in
    one launch (``train_kernel.fused_train``).

Double precision (``dtype=torch.float64``) differentiates through the
oracle only, as in JAX: ``make_loss_fn`` / ``render_grads`` /
``make_train_step`` with ``impl='oracle'``; the Adam state follows the
parameters' dtype. ``mesh=`` (``parallel/mesh.py``) shards every
implementation's pixels over the ranks of a process group; the
parameters step alike on every rank, since every rank holds the same
summed gradients.

The optimizer is ``torch.optim.Adam`` (``optax.adam``'s counterpart, with
the same defaults) unless ``optimizer=`` gives a ``torch.optim`` factory
(the JAX ``optimizer=`` argument, which takes an optax transformation); a
``trainable`` mask freezes parameter groups as ``optax.multi_transform``
with ``set_to_zero`` does: a frozen leaf takes no update and its
optimizer state does not change.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..models.camera import (CameraConfig, config_from_leaves, config_leaves,
                             initialize)
from ..models.scene import Scene, SceneParams, param_leaves, params_from_leaves
from ..parallel import mesh as meshlib
from ..utils import trace
from . import tracer
from .render_kernel import make_diff_render
from .stream_kernel import (StreamScene, build_stream_arrays,
                            front_to_back_order, render_stream)
from .stream_train_kernel import (RECORD_BUDGET, mse_train_stream,
                                  render_stream_grads,
                                  stream_grads_to_scene_mat)
from .train_kernel import chain_to_params, fused_train, refuse_unported

_STREAM = ("impl='stream' trains streamed scenes through make_stream_train "
           "(the JAX make_loss_fn falls back to its oracle here)")


def image_mse(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = img - target
    return torch.mean(d * d)


def image_loss(img: torch.Tensor, target: torch.Tensor, loss: str = "mse",
               huber_delta: float = 1.0) -> torch.Tensor:
    """The per-pixel loss family of the fused kernel: 'mse' | 'l1' |
    'huber' | 'relmse', each a mean over pixels and channels."""
    d = img - target
    if loss == "mse":
        return torch.mean(d * d)
    if loss == "l1":
        return torch.mean(d.abs())
    if loss == "huber":
        a = d.abs()
        return torch.mean(torch.where(a <= huber_delta, 0.5 * d * d,
                                      huber_delta * (a - 0.5 * huber_delta)))
    if loss == "relmse":
        return torch.mean(d * d / (target * target + 1e-2))
    raise ValueError(f"unknown loss {loss!r}")


def make_loss_fn(img_width: int, img_height: int, samples_per_pixel: int,
                 max_depth: int, *, seed: int = 1227, dtype=torch.float32,
                 chunk_pixels: Optional[int] = None, gamma: bool = False,
                 impl: str = "oracle", pixel_order=None, mesh=None,
                 rr_start=None, layout: str = "vmem",
                 ray_tile: Optional[int] = None,
                 bwd_ray_tile: Optional[int] = None,
                 sweep: Optional[str] = None, window: int = 0,
                 pixels_per_lane: Optional[int] = None, loss: str = "mse",
                 huber_delta: float = 1.0):
    """``loss(params, cam_cfg, mat_type, active, target) -> scalar``,
    differentiable by autograd, computed on the params' device (the
    kernels on a card, their plain versions on the CPU).

    The loss is taken in linear radiance by default (``gamma=False``):
    sqrt-gamma has an unbounded slope at black, and absorbed paths are
    black. ``impl='kernel'`` renders with ``make_diff_render`` (the regen
    kernel forward, the gradient kernel backward); ``impl='oracle'``
    with ``tracer.render``, in ``dtype`` (float32, or float64 for the f64
    oracle: the image and the loss in double). ``rr_start`` selects the
    Russian-roulette estimator for both. ``mesh``: each rank renders and
    differentiates its slice of the pixels, the image reaches every rank
    (one ``all_reduce``) and so the loss is the same on every rank, and
    the gradients are summed over the ranks (one more, in the backward
    pass). ``ray_tile``, ``bwd_ray_tile``, ``sweep``, ``window`` and
    ``pixels_per_lane`` tuned the TPU kernels: ignored under
    ``impl='kernel'``, refused under ``impl='oracle'`` as the JAX package
    refuses them. The JAX package's ``pixel_sharding`` is ``mesh`` here;
    its ``remat`` has no counterpart and is dropped."""
    refuse_unported(dtype if impl == "kernel" else torch.float32, layout)
    meshlib.validate(mesh)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype!r}")
    if impl == "stream":
        raise ValueError(_STREAM)
    if impl not in ("oracle", "kernel"):
        raise ValueError(f"impl must be 'oracle' or 'kernel', got {impl!r}")
    if impl != "kernel":
        unsupported = {
            "ray_tile": ray_tile, "bwd_ray_tile": bwd_ray_tile,
            "sweep": sweep, "window": window or None,
            "pixels_per_lane": pixels_per_lane,
        }
        named = [k for k, v in unsupported.items() if v is not None]
        if named:
            raise ValueError(
                f"impl={impl!r} does not support {named}: these tune the "
                "kernels; use impl='kernel' or impl='fused'")

    def loss_fn(params: SceneParams, cam_cfg: CameraConfig, mat_type,
                active, target):
        if impl == "kernel":
            img = make_diff_render(
                mat_type, active, img_width, img_height, samples_per_pixel,
                max_depth, seed=seed, gamma=gamma, pixel_order=pixel_order,
                rr_start=rr_start, layout=layout, mesh=mesh)(params, cam_cfg)
        else:
            img = tracer.render(
                Scene(params=params, mat_type=mat_type, active=active),
                cam_cfg, img_width, img_height, samples_per_pixel, max_depth,
                seed=seed, dtype=dtype, chunk_pixels=chunk_pixels,
                gamma=gamma, rr_start=rr_start, mesh=mesh)
        return image_loss(img, target, loss, huber_delta)

    return loss_fn


def _value_and_grad(loss_fn, params, cam_cfg, mat_type, active, target):
    p_leaves = [t.detach().requires_grad_(True) for t in param_leaves(params)]
    c_leaves = [t.detach().requires_grad_(True)
                for t in config_leaves(cam_cfg)]
    loss = loss_fn(params_from_leaves(p_leaves), config_from_leaves(c_leaves),
                   mat_type, active, target)
    grads = torch.autograd.grad(loss, p_leaves + c_leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, p_leaves + c_leaves)]
    return loss.detach(), (params_from_leaves(grads[:9]),
                           config_from_leaves(grads[9:]))


def render_grads(scene: Scene, cam_cfg: CameraConfig, target,
                 img_width: int, img_height: int, samples_per_pixel: int,
                 max_depth: int, **kw):
    """(loss, (scene-param grads, camera grads)) for one target image, on
    the scene's device."""
    loss_fn = make_loss_fn(img_width, img_height, samples_per_pixel,
                           max_depth, **kw)
    return _value_and_grad(loss_fn, scene.params, cam_cfg, scene.mat_type,
                           scene.active, target)


def front_to_back_border(stream, cam_cfg: CameraConfig, img_width: int,
                         img_height: int) -> torch.Tensor:
    """The walk's block visit order for ``build_stream_arrays``: the
    canonical (Morton) block indices sorted by the camera distance of their
    bounds (distance - bound radius, empty blocks last), int32 on the
    bounds' device. The prepared bounds rows may already be in camera order
    (``camdist_from``), so each row's canonical index comes from its
    first-row column. Speed only: the image and gradients are the same
    but for exact ties between blocks."""
    order = front_to_back_order(
        stream.bounds, initialize(cam_cfg, img_width, img_height).center)
    first = stream.bounds.detach()[order, 4]
    return torch.round(first / stream.block).to(torch.int32)


class AdamState(NamedTuple):
    """optax.adam's state: the step count and both moments, one leaf per
    SceneParams leaf (frozen leaves keep zero moments)."""
    count: torch.Tensor     # int32 scalar
    mu: SceneParams
    nu: SceneParams


class OptimizerState(NamedTuple):
    """The state of an ``optimizer=`` train step: the optimizer's class
    name, the step count and, for each of the 9 SceneParams leaves, the
    ``torch.optim`` per-parameter state dict (empty for frozen leaves)."""
    name: str
    count: torch.Tensor     # int32 scalar
    per_leaf: tuple


class TrainState(NamedTuple):
    params: SceneParams
    opt_state: "AdamState | OptimizerState"
    step: torch.Tensor      # int32 scalar


def train_state_leaves(state: TrainState) -> list:
    """The 29 tensors of an Adam TrainState: 9 params, count, 9 mu, 9 nu,
    step. A state of another optimizer has no such layout and raises
    (``utils.checkpoint.save_train_state`` saves it key by key)."""
    if not isinstance(state.opt_state, AdamState):
        raise TypeError(
            f"the train state holds {type(state.opt_state).__name__} of "
            f"{getattr(state.opt_state, 'name', '?')} (make_train_step("
            f"optimizer=...)); only the default Adam state has the 29-leaf "
            f"layout")
    return [*param_leaves(state.params), state.opt_state.count,
            *param_leaves(state.opt_state.mu),
            *param_leaves(state.opt_state.nu), state.step]


def train_state_from_leaves(leaves) -> TrainState:
    """Inverse of ``train_state_leaves``."""
    leaves = list(leaves)
    if len(leaves) != 29:
        raise ValueError(f"a TrainState has 29 leaves, got {len(leaves)}")
    return TrainState(
        params=params_from_leaves(leaves[:9]),
        opt_state=AdamState(leaves[9], params_from_leaves(leaves[10:19]),
                            params_from_leaves(leaves[19:28])),
        step=leaves[28],
    )


def _trained(trainable) -> list:
    """The indices of the SceneParams leaves ``trainable`` selects."""
    return [i for i, t in enumerate(
        [True] * 9 if trainable is None else param_leaves(trainable)) if t]


def _init_state(params: SceneParams, opt_state: Callable) -> TrainState:
    """A step-0 TrainState over copies of ``params``'s leaves, with the
    optimizer state ``opt_state(leaves, count)``."""
    leaves = [t.detach().clone() for t in param_leaves(params)]
    zero = lambda: torch.zeros((), dtype=torch.int32,  # noqa: E731
                               device=leaves[0].device)
    return TrainState(params_from_leaves(leaves), opt_state(leaves, zero()),
                      zero())


def _step_leaves(params: SceneParams, d_params: SceneParams, train: list,
                 make_opt: Callable, state_of: Callable) -> tuple:
    """One optimizer step of the leaves ``train`` indexes, on copies of
    ``params``'s leaves: ``make_opt(tensors)`` builds the optimizer over
    them, and leaf i takes ``state_of(i)`` as its optimizer state (none
    where that is empty) and ``d_params``'s leaf i as its gradient.
    Returns (the 9 leaves, {i: leaf i's optimizer state after the step})."""
    leaves = [t.detach().clone() for t in param_leaves(params)]
    if not train:
        return leaves, {}
    opt, grads = make_opt([leaves[i] for i in train]), param_leaves(d_params)
    for i in train:
        leaves[i].grad = grads[i].detach().to(leaves[i].dtype)
        if state := state_of(i):
            opt.state[leaves[i]] = state
    opt.step()
    for i in train:
        leaves[i].grad = None
    return leaves, {i: opt.state[leaves[i]] for i in train}


def _adam(learning_rate: float, trainable):
    """``(init_fn, apply)`` for Adam over the SceneParams leaves:
    ``torch.optim.Adam(lr=learning_rate)`` with optax's defaults (betas
    0.9/0.999, eps 1e-8); ``trainable``, a SceneParams of bools, selects
    the leaves it updates."""
    train = _trained(trainable)

    def zeros(leaves, count):
        z = params_from_leaves([torch.zeros_like(t) for t in leaves])
        return AdamState(count, z, z)

    @trace.spanned("rt.optim")
    def apply(state: TrainState, d_params: SceneParams):
        mu = [t.clone() for t in param_leaves(state.opt_state.mu)]
        nu = [t.clone() for t in param_leaves(state.opt_state.nu)]
        count = 0.0
        if train:
            with trace.sync():
                count = float(state.opt_state.count)
        leaves, _ = _step_leaves(
            state.params, d_params, train,
            lambda ts: torch.optim.Adam(ts, lr=learning_rate),
            lambda i: {"step": torch.tensor(count, dtype=torch.float32),
                       "exp_avg": mu[i], "exp_avg_sq": nu[i]})
        opt_state = AdamState(state.opt_state.count + 1,
                              params_from_leaves(mu), params_from_leaves(nu))
        return params_from_leaves(leaves), opt_state

    return lambda params: _init_state(params, zeros), apply


def _torch_optimizer(factory: Callable, trainable):
    """``(init_fn, apply)`` for any ``torch.optim`` optimizer:
    ``factory(tensors)`` builds it over the trainable leaves each step,
    with each leaf's state dict carried in an ``OptimizerState`` (copied,
    so a state is never changed in place)."""
    train = _trained(trainable)

    def copy(st: dict) -> dict:
        return {k: v.clone() if torch.is_tensor(v) else v
                for k, v in st.items()}

    def init_fn(params: SceneParams) -> TrainState:
        name = getattr(factory, "func", factory).__name__
        return _init_state(params, lambda leaves, count: OptimizerState(
            name, count, tuple({} for _ in leaves)))

    @trace.spanned("rt.optim")
    def apply(state: TrainState, d_params: SceneParams):
        per_leaf = list(state.opt_state.per_leaf)
        leaves, after = _step_leaves(state.params, d_params, train, factory,
                                     lambda i: copy(per_leaf[i]))
        for i, st in after.items():
            per_leaf[i] = copy(st)
        opt_state = state.opt_state._replace(
            count=state.opt_state.count + 1, per_leaf=tuple(per_leaf))
        return params_from_leaves(leaves), opt_state

    return init_fn, apply


def _optimizer(optimizer: Optional[Callable], learning_rate: float,
               trainable):
    if optimizer is None:
        return _adam(learning_rate, trainable)
    return _torch_optimizer(optimizer, trainable)


def make_train_step(img_width: int, img_height: int, samples_per_pixel: int,
                    max_depth: int, optimizer: Optional[Callable] = None,
                    learning_rate: float = 1e-2, trainable=None, **kw):
    """Build ``(init_fn, step_fn)`` for inverse rendering;
    ``step_fn(state, cam_cfg, mat_type, active, target) -> (state,
    loss)``, run on the state's device (that of the params ``init_fn``
    was given).

    ``impl`` (in ``kw``): 'oracle' (default), 'kernel' or 'fused'; the
    other keywords go to ``make_loss_fn`` or, for 'fused', to
    ``fused_train`` (``gamma``, ``seed``, ``pixel_order``, ``rr_start``,
    ``loss``, ``huber_delta``, ``layout``, ``mesh``; the TPU knobs are
    ignored).
    ``trainable``: a SceneParams of bools selecting the leaves the
    optimizer updates. By default the optimizer is
    ``torch.optim.Adam(lr=learning_rate)`` with optax's defaults (betas
    0.9/0.999, eps 1e-8), its state an ``AdamState``. ``optimizer``, the
    JAX argument's counterpart, is a factory of a ``torch.optim``
    optimizer over a list of tensors, for example
    ``functools.partial(torch.optim.SGD, lr=1e-2, momentum=0.9)``
    (``learning_rate`` is then unused); its state is an
    ``OptimizerState``, which ``utils/checkpoint.save_train_state``
    saves key by key."""
    impl = kw.get("impl", "oracle")
    if impl == "stream":
        raise ValueError(_STREAM)
    if impl not in ("oracle", "kernel", "fused"):
        raise ValueError(f"impl must be 'oracle', 'kernel' or 'fused', got "
                         f"{impl!r}")
    init_fn, apply = _optimizer(optimizer, learning_rate, trainable)

    if impl == "fused":
        fused_kw = {k: kw[k] for k in ("seed", "pixel_order", "rr_start",
                                       "loss", "huber_delta", "layout",
                                       "mesh", "dtype")
                    if k in kw}
        gamma = kw.get("gamma", False)

        @trace.spanned("rt.train_step")
        def fused_step(state: TrainState, cam_cfg: CameraConfig, mat_type,
                       active, target):
            scene = Scene(params=state.params, mat_type=mat_type,
                          active=active)
            loss, _img, d_sm, d_cr = fused_train(
                scene, cam_cfg, target, img_width, img_height,
                samples_per_pixel, max_depth, gamma=gamma, **fused_kw)
            d_params, _ = chain_to_params(d_sm, d_cr, state.params, cam_cfg,
                                          mat_type, active, img_width,
                                          img_height)
            params, opt_state = apply(state, d_params)
            return TrainState(params, opt_state, state.step + 1), loss

        return init_fn, fused_step

    if kw.pop("park_residuals", None) is not None:
        raise ValueError("park_residuals tunes the fused kernel only: use "
                         "impl='fused'")
    loss_fn = make_loss_fn(img_width, img_height, samples_per_pixel,
                           max_depth, **kw)

    @trace.spanned("rt.train_step")
    def step_fn(state: TrainState, cam_cfg: CameraConfig, mat_type, active,
                target):
        loss, (d_params, _) = _value_and_grad(loss_fn, state.params, cam_cfg,
                                              mat_type, active, target)
        params, opt_state = apply(state, d_params)
        return TrainState(params, opt_state, state.step + 1), loss

    return init_fn, step_fn


def make_stream_train(stream, img_width: int, img_height: int,
                      samples_per_pixel: int, max_depth: int,
                      optimizer: Optional[Callable] = None,
                      learning_rate: float = 1e-2, trainable=None,
                      seed: int = 1227, fused: bool = True, mesh=None,
                      loss: str = "mse",
                      huber_delta: float = 1.0, budget: int = RECORD_BUDGET):
    """Inverse rendering for streamed scenes: ``(init_fn, step_fn)`` with
    ``step_fn(state, cam_cfg, mat_type, active, target) -> (state,
    loss)``, as ``make_train_step``, on the device of ``stream`` and the
    state.

    ``fused=True`` runs render, loss and gradients in one launch
    (``stream_train_kernel.mse_train_stream``); ``fused=False`` renders
    (``render_stream``), takes the loss's gradient on the host and runs the
    kernel's gradient mode; the two agree up to summation order. The
    Morton permutation and block assignment are frozen from ``stream``
    (``prepare_stream_scene``); each step rebuilds the matrix and bounds
    from the current parameters on their device (``build_stream_arrays``),
    with the blocks visited front to back from the first step's camera.
    The loss is taken in linear radiance. The optimizer (Adam, or
    ``optimizer``) as in ``make_train_step``; the JAX ``interpret`` and
    ``lane_group`` (the TPU schedule) arguments have no counterpart.
    ``mesh``: each rank steps its slice of the pixels; a fused step makes
    one ``all_reduce`` (the loss and the cotangents), a ``fused=False``
    step two (the image's, then the cotangents'). ``budget`` bounds the
    gradient records a launch holds (``stream_train_kernel.plan_records``);
    a fused step whose records need more than one window takes the
    ``fused=False`` route on the card (render, loss, gradient windows)."""
    meshlib.validate(mesh)
    init_fn, apply = _optimizer(optimizer, learning_rate, trainable)
    block, n_pad, perm = stream.block, stream.scene_mat.shape[0], stream.perm
    border: dict = {}

    def stream_of(params, mat_type, active, cam_cfg) -> StreamScene:
        if "b" not in border:
            border["b"] = front_to_back_border(stream, cam_cfg, img_width,
                                               img_height)
        sm, bounds = build_stream_arrays(Scene(params, mat_type, active),
                                         perm, block, n_pad,
                                         border=border["b"])
        return StreamScene(sm, bounds, block, perm)

    @trace.spanned("rt.stream_step")
    def step_fn(state: TrainState, cam_cfg: CameraConfig, mat_type, active,
                target):
        st = stream_of(state.params, mat_type, active, cam_cfg)
        kw = dict(seed=seed, mesh=mesh, budget=budget)
        if fused:
            loss_v, d_stream, d_cr = mse_train_stream(
                st, cam_cfg, target, img_width, img_height, samples_per_pixel,
                max_depth, loss=loss, huber_delta=huber_delta, **kw)
        else:
            img = render_stream(st, cam_cfg, img_width, img_height,
                                samples_per_pixel, max_depth, gamma=False,
                                seed=seed, mesh=mesh).requires_grad_(True)
            with torch.enable_grad():
                loss_v = image_loss(img, torch.as_tensor(target).to(img),
                                    loss, huber_delta)
                (g_img,) = torch.autograd.grad(loss_v, img)
            d_stream, d_cr = render_stream_grads(
                st, cam_cfg, g_img / samples_per_pixel, img_width,
                img_height, samples_per_pixel, max_depth, **kw)
            loss_v = loss_v.detach()
        d_sm = stream_grads_to_scene_mat(d_stream, st, mat_type.shape[0])
        d_params, _ = chain_to_params(d_sm, d_cr, state.params, cam_cfg,
                                      mat_type, active, img_width, img_height)
        params, opt_state = apply(state, d_params)
        return TrainState(params, opt_state, state.step + 1), loss_v

    return init_fn, step_fn
