"""Faults planted under the timed path, to show that the check catches
them (``control.py --mode <fault>`` on the card, and the tests here):

- ``state_unchanged``: every train step returns the state it was given;
- ``params_unchanged``: Adam updates its moments and count but returns
  the parameters it was given;
- ``half_batch``: the kernels see the first half of the lanes alone, and
  the loss and gradients are scaled up to a mean over that half (a
  render leaves the other half's pixels black);
- ``altered``: the answer is changed where it is produced: the render
  kernel's output scaled by 1 + 1e-3, the fused train kernels' loss by
  1.01.
"""
from __future__ import annotations

import contextlib

NAMES = ("state_unchanged", "params_unchanged", "half_batch", "altered")


def _half(ids):
    return max(128, ids.shape[0] // 2 // 128 * 128)


def _patch(mod, name, make):
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    return lambda: setattr(mod, name, orig)


def _unchanged(factory):
    def make(*a, **kw):
        init_fn, step_fn = factory(*a, **kw)

        def step(state, *args):
            return state, step_fn(state, *args)[1]

        return init_fn, step

    return make


def _params_kept(adam):
    def make(*a, **kw):
        init_fn, apply = adam(*a, **kw)

        def run(state, d_params):
            return state.params, apply(state, d_params)[1]

        return init_fn, run

    return make


def _half_fused(orig):
    """A fused train dispatcher over the first half of the lanes."""
    def run(ids, ii, jj, rows, *rest, **kw):
        n, h = ids.shape[0], _half(ids)
        total, img, d_scene, d_cam = orig(ids[:h], ii[:h], jj[:h],
                                          rows[:, :h].contiguous(), *rest,
                                          **kw)
        full = img.new_zeros((img.shape[0], n))
        full[:, :h] = img
        k = n / h
        return total * k, full, d_scene * k, d_cam * k

    return run


def _half_regen(orig):
    def run(ids, ii, jj, budget, *rest, **kw):
        h = _half(ids)
        out = orig(ids[:h], ii[:h], jj[:h], budget[:h].contiguous(), *rest,
                   **kw)
        full = out.new_zeros((out.shape[0], ids.shape[0]))
        full[:, :h] = out
        return full

    return run


def _scaled(orig, k, first_only):
    def run(*a, **kw):
        out = orig(*a, **kw)
        if first_only:
            return (out[0] * k, *out[1:])
        return out * k

    return run


@contextlib.contextmanager
def planted(name):
    """Plant fault ``name`` (None: none) in the port for the block."""
    from raytracingincuda_torch.ops import grad, render_kernel
    from raytracingincuda_torch.ops import stream_train_kernel as stk
    from raytracingincuda_torch.ops import train_kernel as tk

    undo = []
    if name == "state_unchanged":
        undo += [_patch(grad, "make_train_step", _unchanged),
                 _patch(grad, "make_stream_train", _unchanged)]
    elif name == "params_unchanged":
        undo.append(_patch(grad, "_adam", _params_kept))
    elif name == "half_batch":
        undo += [_patch(tk, "_fused", _half_fused),
                 _patch(stk, "_fused", _half_fused),
                 _patch(render_kernel, "_regen", _half_regen)]
    elif name == "altered":
        undo += [_patch(tk, "_fused", lambda o: _scaled(o, 1.01, True)),
                 _patch(stk, "_fused", lambda o: _scaled(o, 1.01, True)),
                 _patch(render_kernel, "_regen",
                        lambda o: _scaled(o, 1.0 + 1e-3, False))]
    elif name is not None:
        raise ValueError(f"no fault {name!r}; one of {NAMES}")
    try:
        yield
    finally:
        for u in reversed(undo):
            u()
