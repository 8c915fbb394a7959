"""Incremental rendering and train-state checkpoints.

The counterpart of ``raytracingincuda_tpu/utils/checkpoint.py``. The
Monte-Carlo accumulator is a sum over counter-keyed sample streams, so a
render of samples [0, k) checkpointed and resumed with [k, n) adds up to
the single [0, n) render (up to summation order). A train state is its
29 tensors (``ops.grad.train_state_leaves``); a resumed run matches an
uninterrupted one bit for bit.

Format: one ``.npz``, written atomically, with an identifying token that
loading checks, so a checkpoint cannot silently continue another render
or run. Loading a train state refuses a leaf whose dtype or shape differs
from the template's; the JAX package casts dtypes quietly there.
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
from ..models.scene import Scene
from ..ops import tracer
from ..ops.grad import train_state_from_leaves, train_state_leaves
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
    float32. A float64 config keeps its sum and image in double (JAX casts
    each round to f32) and renders with ``impl='oracle'`` only: the f64
    kernel takes no ``sample_offset``."""
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
    return tracer._linear_to_gamma(img).numpy()


def save_train_state(path: str, state, token: str = "") -> None:
    """Checkpoint an ``ops.grad.TrainState`` (params, Adam state, step).
    ``token`` identifies the run (training config, scene hash) and is
    checked on load."""
    leaves = train_state_leaves(state)
    _save(path, token=np.frombuffer(token.encode(), np.uint8),
          n_leaves=np.int64(len(leaves)),
          **{f"leaf_{i}": v.detach().cpu().numpy()
             for i, v in enumerate(leaves)})


def load_train_state(path: str, template, token: str = ""):
    """Restore a TrainState saved by ``save_train_state``, bit for bit,
    onto the devices of ``template`` (e.g. a fresh ``init_fn(params)``).
    A leaf whose shape or dtype differs from the template's is refused."""
    z = np.load(_npz_path(path))
    saved = bytes(z["token"]).decode()
    if saved != token:
        raise ValueError(f"train checkpoint {path} belongs to a different "
                         f"run:\n  checkpoint: {saved!r}\n  requested:  "
                         f"{token!r}")
    tleaves = train_state_leaves(template)
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
    return train_state_from_leaves(leaves)
