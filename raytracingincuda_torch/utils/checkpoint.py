"""Incremental rendering and train-state checkpoints.

The counterpart of ``raytracingincuda_tpu/utils/checkpoint.py``. The
Monte-Carlo accumulator is a sum over counter-keyed sample streams, so a
render of samples [0, k) checkpointed and resumed with [k, n) adds up to
the single [0, n) render (up to summation order). An Adam train state is
its 29 tensors (``ops.grad.train_state_leaves``); the state of any other
``torch.optim`` optimizer (``optimizer=``, an ``ops.grad.OptimizerState``)
is its 9 params, count, step, the optimizer's name and each leaf's state
dict key by key, with each entry's key and kind recorded. A resumed run
matches an uninterrupted one bit for bit.

Format: one ``.npz``, written atomically, with an identifying token that
loading checks, so a checkpoint cannot silently continue another render
or run. Loading a train state refuses a file of another optimizer and a
leaf whose dtype or shape differs from the template's; the JAX package
casts dtypes quietly there.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..models.camera import CameraConfig
from ..models.scene import Scene, param_leaves, params_from_leaves
from ..ops import tracer
from ..ops.grad import (OptimizerState, TrainState, train_state_from_leaves,
                        train_state_leaves)
from ..render_api import make_sum_renderer


def _config_token(cfg: RenderConfig) -> str:
    d = dataclasses.asdict(cfg)
    d.pop("chunk_pixels", None)  # execution detail, not identity
    d.pop("impl", None)          # oracle and kernel accumulate the same sums
    return json.dumps(d, sort_keys=True)


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' to a path without it and np.load does not:
    normalise once so that save and load agree."""
    return path if path.endswith(".npz") else path + ".npz"


def _save(path: str, **arrays) -> None:
    path = _npz_path(path)
    tmp = path + ".tmp.npz"  # a kill mid-save must not corrupt the last one
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _acc_dtype(cfg: RenderConfig):
    """The accumulator's dtype: a float64 config keeps its sum in double."""
    return np.float64 if cfg.dtype == "float64" else np.float32


def save_checkpoint(path: str, acc: np.ndarray, samples_done: int,
                    cfg: RenderConfig) -> None:
    _save(path, acc=np.asarray(acc, _acc_dtype(cfg)),
          samples_done=np.int64(samples_done),
          config=np.frombuffer(_config_token(cfg).encode(), np.uint8))


def load_checkpoint(path: str, cfg: RenderConfig) -> Tuple[np.ndarray, int]:
    z = np.load(_npz_path(path))
    token = bytes(z["config"]).decode()
    if token != _config_token(cfg):
        raise ValueError(
            f"checkpoint {path} belongs to a different render config:\n"
            f"  checkpoint: {token}\n  requested:  {_config_token(cfg)}")
    return z["acc"], int(z["samples_done"])


def render_incremental(scene: Scene, cam_cfg: CameraConfig, cfg: RenderConfig,
                       *, checkpoint_path: Optional[str] = None,
                       samples_per_round: Optional[int] = None,
                       resume: bool = True) -> np.ndarray:
    """Render ``cfg.samples`` samples in rounds on the scene's device,
    checkpointing the raw sum after each; returns the gamma-encoded
    (H, W, 3) image. A checkpoint of the same config at
    ``checkpoint_path`` is resumed (``resume=True``).

    Each round is ``render_api.make_sum_renderer``'s raw sum, on
    ``make_renderer``'s route for ``cfg`` (JAX renders every round on its
    oracle): the oracle in the config's dtype, kernel 1 or kernel 4 at
    float32, the f64 kernel at float64 with ``impl='kernel'`` (each round
    a window of samples at its ``sample_offset``). A float64 config keeps
    its sum and image in double (JAX casts each round to f32)."""
    render_sum = make_sum_renderer(cfg, scene.mat_type.device)
    acc_dtype = _acc_dtype(cfg)
    acc = np.zeros((cfg.height, cfg.width, 3), acc_dtype)
    done = 0
    if checkpoint_path and resume:
        try:
            acc, done = load_checkpoint(checkpoint_path, cfg)
        except FileNotFoundError:
            pass
    rounds = samples_per_round or cfg.samples
    while done < cfg.samples:
        n = min(rounds, cfg.samples - done)
        part = render_sum(scene, cam_cfg, n, done)
        acc = acc + part.cpu().numpy().astype(acc_dtype)
        done += n
        if checkpoint_path:
            save_checkpoint(checkpoint_path, acc, done, cfg)
    img = torch.from_numpy(acc / acc_dtype(cfg.samples))
    return tracer.linear_to_gamma(img).numpy()


def _text(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8)


# The kinds of a torch.optim state entry: a tensor on the params' device,
# a tensor kept on the CPU beside params on a card (torch.optim's
# non-capturable step counters), a Python number, or None.
_NUMBER_KINDS = {"int": (int, np.int64), "float": (float, np.float64)}


def _entry(v, dev) -> tuple:
    """(kind, array or None) of one torch.optim state entry."""
    if torch.is_tensor(v):
        kind = "tensor" if v.device == dev else "cpu tensor"
        return kind, v.detach().cpu().numpy()
    if v is None:
        return "none", None
    for kind, (py, np_type) in _NUMBER_KINDS.items():
        if type(v) is py:
            return kind, np_type(v)
    raise TypeError(f"a torch.optim state entry of type {type(v).__name__} "
                    f"has no checkpoint layout")


def _optimizer_arrays(state: TrainState) -> dict:
    """An ``OptimizerState`` train state as .npz arrays: leaves 0-8 the
    params, 9 the count, 10 the step; ``state_{leaf}_{j}`` the j-th entry
    of a leaf's state dict; ``layout`` (JSON) each leaf's [key, kind]
    pairs in order."""
    params = param_leaves(state.params)
    dev = params[0].device
    leaves = [*params, state.opt_state.count, state.step]
    arrays = {f"leaf_{i}": v.detach().cpu().numpy()
              for i, v in enumerate(leaves)}
    layout = []
    for i, st in enumerate(state.opt_state.per_leaf):
        pairs = []
        for j, (key, v) in enumerate(st.items()):
            kind, arr = _entry(v, dev)
            if arr is not None:
                arrays[f"state_{i}_{j}"] = arr
            pairs.append([key, kind])
        layout.append(pairs)
    return dict(arrays, n_leaves=np.int64(len(leaves)),
                optimizer=_text(state.opt_state.name),
                layout=_text(json.dumps(layout)))


def save_train_state(path: str, state, token: str = "") -> None:
    """Checkpoint an ``ops.grad.TrainState``: params, optimizer state and
    step; an Adam state as its 29 leaves, any other ``torch.optim``
    optimizer's as ``_optimizer_arrays`` lays it out. ``token``
    identifies the run (training config, scene hash) and is checked on
    load."""
    if isinstance(state.opt_state, OptimizerState):
        arrays = _optimizer_arrays(state)
    else:
        leaves = train_state_leaves(state)
        arrays = dict(n_leaves=np.int64(len(leaves)),
                      **{f"leaf_{i}": v.detach().cpu().numpy()
                         for i, v in enumerate(leaves)})
    _save(path, token=_text(token), **arrays)


def _checked_leaves(z, tleaves: list, path: str) -> list:
    """The file's leaves, each held to its template leaf's shape and
    dtype and moved to its device."""
    n = int(z["n_leaves"])
    if n != len(tleaves):
        raise ValueError(f"train checkpoint {path} has {n} leaves; the "
                         f"template has {len(tleaves)}")
    leaves = []
    for i, t in enumerate(tleaves):
        v = torch.from_numpy(np.array(z[f"leaf_{i}"], copy=True))
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(v.shape)} "
                             f"!= template shape {tuple(t.shape)}")
        if v.dtype != t.dtype:
            raise ValueError(f"leaf {i}: checkpoint dtype {v.dtype} != "
                             f"template dtype {t.dtype}; refusing to cast")
        leaves.append(v.to(t.device))
    return leaves


def _optimizer_state(z, template: TrainState, path: str) -> TrainState:
    """Inverse of ``_optimizer_arrays`` onto ``template``'s devices. The
    per-leaf structure comes from the file: a fresh ``init_fn`` holds
    empty dicts."""
    params = param_leaves(template.params)
    dev = params[0].device
    leaves = _checked_leaves(z, [*params, template.opt_state.count,
                                 template.step], path)
    per_leaf = []
    for i, pairs in enumerate(json.loads(bytes(z["layout"]).decode())):
        st = {}
        for j, (key, kind) in enumerate(pairs):
            if kind == "none":
                st[key] = None
            elif kind in _NUMBER_KINDS:
                st[key] = _NUMBER_KINDS[kind][0](z[f"state_{i}_{j}"][()])
            else:
                v = torch.from_numpy(np.array(z[f"state_{i}_{j}"], copy=True))
                st[key] = v.to(dev) if kind == "tensor" else v
        per_leaf.append(st)
    return TrainState(
        params=params_from_leaves(leaves[:9]),
        opt_state=template.opt_state._replace(count=leaves[9],
                                              per_leaf=tuple(per_leaf)),
        step=leaves[10])


def load_train_state(path: str, template, token: str = ""):
    """Restore a TrainState saved by ``save_train_state``, bit for bit,
    onto the devices of ``template`` (e.g. a fresh ``init_fn(params)``),
    whose optimizer must be the file's: an Adam state, or an
    ``OptimizerState`` of the same name. A leaf whose shape or dtype
    differs from the template's is refused."""
    z = np.load(_npz_path(path))
    saved = bytes(z["token"]).decode()
    if saved != token:
        raise ValueError(f"train checkpoint {path} belongs to a different "
                         f"run:\n  checkpoint: {saved!r}\n  requested:  "
                         f"{token!r}")
    name = bytes(z["optimizer"]).decode() if "optimizer" in z.files else None
    want = (template.opt_state.name
            if isinstance(template.opt_state, OptimizerState) else None)
    if name != want:
        raise ValueError(f"train checkpoint {path} holds the state of "
                         f"{name or 'Adam (the default)'}; the template's "
                         f"optimizer is {want or 'Adam (the default)'}")
    if name is not None:
        return _optimizer_state(z, template, path)
    return train_state_from_leaves(
        _checked_leaves(z, train_state_leaves(template), path))
