"""The layer under the kernel wrappers (ops/kernel_io.py) on the CPU.

``scene_cotangent``, the packing's inverse that ``chain_to_params``
reads the scene's cotangent with, equals autograd through
``pack_scene_matrix`` bit for bit, on the cotangents the gradient, fused
and stream paths hand it. Each wrapper's dispatcher (``by_device``) runs
the plain version on CPU tensors and raises for a ``meta`` tensor. The
module attributes the benchmark patches (its fault injector) are looked up
at call time: patching each changes what its entry point returns.
"""
import importlib

import pytest
import torch

from raytracingincuda_torch.models.camera import CameraConfig
from raytracingincuda_torch.models.scene import (Scene, build_scene,
                                                 param_leaves,
                                                 params_from_leaves)
from raytracingincuda_torch.ops import grad as tgrad
from raytracingincuda_torch.ops import kernel_io as kio
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import stream_kernel as sk
from raytracingincuda_torch.ops import stream_train_kernel as stk
from raytracingincuda_torch.ops import train_kernel as tk
from raytracingincuda_torch.ops.f64_kernel import f64_inputs

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

W, H, SPP, DEPTH, BLOCK = 16, 8, 1, 3, 32


@pytest.fixture(scope="module")
def setup():
    s = build_scene(2, device="cpu")
    cam = CameraConfig.reference_default()
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(5))
    return s, cam, target, sk.prepare_stream_scene(s, block=BLOCK)


def _cotangent(path, s, cam, target, st):
    """The (N, 16) scene-matrix cotangent a path gives chain_to_params."""
    if path == "grad":
        return tk.render_kernel_grads(s, cam, target, W, H, SPP, DEPTH)[0]
    if path == "fused":
        return tk.fused_train(s, cam, target, W, H, SPP, DEPTH)[2]
    d_stream = stk.mse_train_stream(st, cam, target, W, H, SPP, DEPTH)[1]
    return stk.stream_grads_to_scene_mat(d_stream, st, s.num_slots)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cols", [kio.NUM_COLS, kio.GRAD_COLS])
@pytest.mark.parametrize("path", ["grad", "fused", "stream"])
def test_scene_cotangent_equals_autograd(setup, path, cols, dtype):
    s, cam, target, st = setup
    d_sm = _cotangent(path, s, cam, target, st)
    assert d_sm.shape == (s.num_slots, kio.NUM_COLS) and bool(d_sm.any())
    params = params_from_leaves([t.to(dtype) for t in param_leaves(s.params)])
    leaves = [t.detach().requires_grad_(True) for t in param_leaves(params)]
    with torch.enable_grad():
        m = kio.pack_scene_matrix(Scene(params_from_leaves(leaves),
                                        s.mat_type, s.active))
        want = torch.autograd.grad(m, leaves, d_sm)
    got = param_leaves(kio.scene_cotangent(d_sm[:, :cols].contiguous(),
                                           params))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.is_contiguous()
        assert torch.equal(g, w)
    chained, _ = tk.chain_to_params(d_sm, torch.zeros((1, 24)), params, cam,
                                    s.mat_type, s.active, W, H)
    for g, w in zip(param_leaves(chained), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["fused", "stream"])
def test_steps_chain_the_scene_part_alone(setup, monkeypatch, kind):
    """The fused and the stream train steps take ``chain_to_scene``, the
    chain's scene part alone: two steps give the states and losses, bit
    for bit, that they give with ``chain_to_params``' scene cotangent in
    its place."""
    s, cam, target, st = setup
    if kind == "fused":
        init_fn, step_fn = tgrad.make_train_step(W, H, SPP, DEPTH,
                                                 impl="fused", gamma=True,
                                                 rr_start=2)
    else:
        init_fn, step_fn = tgrad.make_stream_train(st, W, H, SPP, DEPTH)
    calls = []

    def scene_only(d_sm, params):
        calls.append(d_sm)
        return tk.chain_to_scene(d_sm, params)

    def full_chain(d_sm, params):
        return tk.chain_to_params(d_sm, torch.zeros((1, 24)), params, cam,
                                  s.mat_type, s.active, W, H)[0]

    runs = []
    for chain in (scene_only, full_chain):
        monkeypatch.setattr(tgrad, "chain_to_scene", chain)
        state, losses = init_fn(s.params), []
        for _ in range(2):
            state, loss = step_fn(state, cam, s.mat_type, s.active, target)
            losses.append(loss)
        runs.append((tgrad.train_state_leaves(state), losses))
    assert len(calls) == 2 and all(bool(d.any()) for d in calls)
    (got, got_loss), (want, want_loss) = runs
    assert int(got[9]) == 2 and got[9].device.type == "cpu"
    for a, b in zip(got + got_loss, want + want_loss):
        assert torch.equal(a, b)


def _calls(s, cam, target, st):
    """(module, dispatcher) -> the arguments and keywords of a call."""
    ids, ii, jj, bud, sm, row = rk.regen_inputs(s, cam, W, H, SPP)
    rows = kio.lane_rows(target, ids, W * H)
    stream = (st.scene_mat, st.bounds, row)
    keys, src = stk.record_order(torch.tensor([3, -1, 0, 3, 1],
                                              dtype=torch.int32), 4)
    vals = torch.rand((5, kio.GRAD_COLS),
                      generator=torch.Generator().manual_seed(2))
    kw = dict(samples=SPP, max_depth=DEPTH)
    fused = dict(kw, num_pixels=W * H)
    return {
        ("render_kernel", "_regen"): ((ids, ii, jj, bud, sm, row), kw),
        ("compact_kernel", "render_compact"): ((ids, ii, jj, sm, row), kw),
        ("f64_kernel", "_f64"): (f64_inputs(s, cam, W, H), kw),
        ("train_kernel", "_grad"): ((ids, ii, jj, rows, sm, row), kw),
        ("train_kernel", "_fused"): ((ids, ii, jj, rows, sm, row), fused),
        ("stream_kernel", "_stream"): ((ids, ii, jj, bud, *stream),
                                       dict(kw, block=BLOCK)),
        ("stream_train_kernel", "_grads"): ((ids, ii, jj, rows, *stream),
                                            dict(kw, block=BLOCK)),
        ("stream_train_kernel", "_fused"): ((ids, ii, jj, rows, *stream),
                                            dict(fused, block=BLOCK)),
        ("stream_train_kernel", "_segment_sum"): ((keys, src, vals, 5), {}),
    }


# (module, dispatcher, its kernel, its plain version)
DISPATCHERS = [
    ("render_kernel", "_regen", "regen_kernel", "regen_reference"),
    ("compact_kernel", "render_compact", "compact_kernel",
     "compact_reference"),
    ("f64_kernel", "_f64", "f64_kernel", "f64_reference"),
    ("train_kernel", "_grad", "grad_kernel", "grad_reference"),
    ("train_kernel", "_fused", "fused_train_kernel", "fused_train_reference"),
    ("stream_kernel", "_stream", "stream_kernel", "stream_reference"),
    ("stream_train_kernel", "_grads", "stream_grads_kernel",
     "stream_grads_reference"),
    ("stream_train_kernel", "_fused", "fused_stream_kernel",
     "fused_stream_reference"),
    ("stream_train_kernel", "_segment_sum", "segment_sum_kernel",
     "segment_sum_reference"),
]


@pytest.mark.parametrize("module, name, kernel, reference", DISPATCHERS)
def test_dispatcher_routes_by_device(setup, module, name, kernel, reference):
    """CPU tensors take the plain version, on which the kernel raises; a
    tensor on any other device raises before anything runs."""
    mod = importlib.import_module(f"raytracingincuda_torch.ops.{module}")
    args, kw = _calls(*setup)[module, name]
    got = getattr(mod, name)(*args, **kw)
    want = getattr(mod, reference)(*args, **kw)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(mod, kernel)(*args, **kw)
    with pytest.raises(ValueError, match="meta"):
        getattr(mod, name)(args[0].to("meta"), *args[1:], **kw)


def _doubled(orig):
    def run(*a, **kw):
        out = orig(*a, **kw)
        if isinstance(out, tuple):
            return (out[0] * 2.0, *out[1:])
        return out * 2.0
    return run


def _params_kept(adam):
    def make(*a, **kw):
        init_fn, apply = adam(*a, **kw)
        return init_fn, lambda state, d: (state.params, apply(state, d)[1])
    return make


@pytest.mark.parametrize("hook", ["render_kernel._regen",
                                  "stream_kernel._stream",
                                  "train_kernel._fused",
                                  "stream_train_kernel._fused",
                                  "grad._adam"])
def test_benchmark_hooks_take_effect(setup, hook, monkeypatch):
    """Each attribute that the benchmark's fault injector patches is what
    its entry point calls: the entry's answer changes with the patch (an
    answer doubled; for ``_adam``, parameters left where they were)."""
    s, cam, target, st = setup
    module, name = hook.split(".")
    mod = importlib.import_module(f"raytracingincuda_torch.ops.{module}")

    def step():
        init_fn, step_fn = tgrad.make_train_step(W, H, SPP, DEPTH,
                                                 impl="fused")
        state = init_fn(s.params)
        return torch.stack([t for t in param_leaves(
            step_fn(state, cam, s.mat_type, s.active, target)[0].params)])

    run = {
        "render_kernel": lambda: rk.render_kernel(s, cam, W, H, SPP, DEPTH,
                                                  gamma=False),
        "stream_kernel": lambda: sk.render_stream(st, cam, W, H, SPP, DEPTH,
                                                  gamma=False),
        "train_kernel": lambda: tk.fused_train(s, cam, target, W, H, SPP,
                                               DEPTH)[0],
        "stream_train_kernel": lambda: stk.mse_train_stream(
            st, cam, target, W, H, SPP, DEPTH)[0],
        "grad": step,
    }[module]
    plain = run()
    monkeypatch.setattr(mod, name, (_params_kept if name == "_adam"
                                    else _doubled)(getattr(mod, name)))
    patched = run()
    if name == "_adam":
        start = torch.stack(param_leaves(s.params))
        assert not torch.equal(plain, start)
        assert torch.equal(patched, start)
    else:
        assert bool(plain.any()) and torch.equal(patched, plain * 2.0)
