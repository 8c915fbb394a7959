"""The port's span and counter registry (``utils/trace.py``).

Spans off: nothing kept, no profiler range. Spans on: nesting (parent and
root), self time, counters charged to the spans open, the cap, the
records on the clock of torch's profiler, and the span tree and host
syncs of one request of each entry point (``make_renderer``,
``make_train_step``, ``make_stream_train``) on the CPU. The ``cuda``
tests pin the same on the card, where every synchronisation warning of a
request must come from inside an ``rt.sync`` span; they skip without a
card and import nothing of JAX, so ``pytest --noconftest -m cuda`` runs
them.
"""
import os
import sys
import time
import warnings

import pytest
import torch

from raytracingincuda_torch.config import RenderConfig
from raytracingincuda_torch.models.camera import CameraConfig
from raytracingincuda_torch.models.scene import (build_random_scene,
                                                  build_scene,
                                                  params_from_leaves)
from raytracingincuda_torch.ops import grad
from raytracingincuda_torch.ops import stream_kernel as sk
from raytracingincuda_torch.render_api import make_renderer
from raytracingincuda_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes, and
# torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)


def _import_dynamo_past_benchmarks():
    """tests/test_multihost.py puts benchmarks/ first on sys.path while
    pytest collects, and its profile.py shadows the standard library
    module that torch.optim's first optimizer imports (torch._dynamo ->
    cProfile -> profile). Import those with benchmarks/ off the path."""
    if not hasattr(sys.modules.get("profile", sys), "run"):
        sys.modules.pop("profile", None)
    saved = list(sys.path)
    sys.path[:] = [p for p in saved
                   if os.path.basename(os.path.normpath(p)) != "benchmarks"]
    try:
        import torch._dynamo  # noqa: F401
    finally:
        sys.path[:] = saved


_import_dynamo_past_benchmarks()

W, H, SPP, DEPTH = 16, 8, 1, 3
ALBEDOS = params_from_leaves([False] * 4 + [True] * 3 + [False] * 2)


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def test_spans_off_keep_nothing(monkeypatch):
    """Off, a span opens no profiler range and keeps no record; counters
    still count."""
    assert not torch.autograd._profiler_enabled()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("rt.a"):
        with trace.sync():
            trace.count("c", 2)
        assert trace.innermost() is None
    assert trace.records() == [] and trace.dropped() == 0
    assert trace.counts() == {"c": 2, "host_sync": 1}


def test_nesting_parent_and_root():
    with trace.recording():
        with trace.span("a"):
            with trace.span("b"):
                with trace.span("c"):
                    assert trace.innermost() == "c"
            with trace.span("d"):
                pass
        with trace.span("e"):
            pass
    assert trace.innermost() is None
    recs = trace.records()
    assert [r.name for r in recs] == ["a", "b", "c", "d", "e"]
    assert [r.parent for r in recs] == [-1, 0, 1, 0, -1]
    assert [r.root for r in recs] == [0, 0, 0, 0, 4]
    for r in recs:
        assert 0 < r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_self_time():
    """A span's time less its children's is the time it spent alone."""
    with trace.recording():
        with trace.span("outer"):
            time.sleep(0.02)
            with trace.span("inner"):
                time.sleep(0.03)
    outer, inner = trace.records()
    dur = lambda r: r.end_ns - r.start_ns  # noqa: E731
    assert dur(inner) >= 30e6
    assert 20e6 <= dur(outer) - dur(inner) < dur(outer)


def test_counters_charged_to_root():
    trace.count("c")                          # no span open: counted only
    with trace.recording():
        with trace.span("req"):
            trace.count("c")
            with trace.span("part"):
                trace.count("c", 3)
                with trace.sync():
                    pass
        with trace.span("other"):
            pass
    req, part, sync, other = trace.records()
    assert req.counts == {"c": 4, "host_sync": 1}
    assert part.counts == {"c": 3, "host_sync": 1}
    assert sync.name == "rt.sync" and sync.parent == 1 and sync.root == 0
    assert other.counts is None
    assert trace.counts() == {"c": 5, "host_sync": 1}


def test_cap_and_dropped(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    with trace.recording():
        with trace.span("a"):
            for k in range(4):
                with trace.span(f"b{k}"):
                    trace.count("c")
    assert [r.name for r in trace.records()] == ["a", "b0", "b1"]
    assert trace.dropped() == 2
    assert trace.records()[0].counts == {"c": 4}
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0
    assert trace.counts() == {}


def test_records_on_the_profilers_clock():
    """Under a CPU profiler, spans are on without ``recording()``, and each
    record has the profiler's event of its name starting within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with trace.span("rt.outer"):
                with trace.span(f"rt.inner{k}"):
                    torch.ones(64).sum()
    with trace.span("rt.after"):              # off again
        pass
    recs = trace.records()
    assert [r.name for r in recs] == ["rt.outer", "rt.inner0", "rt.outer",
                                      "rt.inner1", "rt.outer", "rt.inner2"]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("rt.")]
    for r in recs:
        near = [abs(e.start_ns() - r.start_ns) for e in events
                if e.name() == r.name]
        assert near and min(near) < 1e6, (r, near)


def _tree() -> list:
    """(name, depth) of each record, in order."""
    recs, out = trace.records(), []
    for r in recs:
        depth, p = 0, r.parent
        while p >= 0:
            depth, p = depth + 1, recs[p].parent
        out.append((r.name, depth))
    return out


def _request(kind: str, device):
    """A tiny request of an entry point, as a callable."""
    cam = CameraConfig.reference_default()
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(
        0)).to(device)
    if kind in ("render", "render_f64"):
        scene = build_scene(2, device=device)
        dtype = "float64" if kind == "render_f64" else "float32"
        cfg = RenderConfig(scene_id=2, width=W, height=H, samples=SPP,
                           bounces=DEPTH, dtype=dtype)
        return lambda: make_renderer(cfg, device)(scene, cam)
    if kind == "train":
        scene = build_scene(2, device=device)
        init_fn, step_fn = grad.make_train_step(
            W, H, SPP, DEPTH, trainable=ALBEDOS, impl="fused", gamma=True,
            rr_start=2)
    else:
        scene = build_random_scene(300, seed=3, device=device)
        init_fn, step_fn = grad.make_stream_train(
            sk.prepare_stream_scene(scene, block=64), W, H, SPP, DEPTH,
            trainable=ALBEDOS)
    box = [init_fn(scene.params)]

    def step():
        box[0], loss = step_fn(box[0], cam, scene.mat_type, scene.active,
                               target)
        return loss

    return step


# A request waits for the card nowhere (PERF.md §3): the camera row goes
# to the card from pinned memory, the stream's bounds are vouched for where
# the port built them, the record sort needs no count from the card, the
# steps take the chain's scene part alone and Adam's count lives on the host.
CHAIN = [("rt.chain", 1), ("rt.chain.scene", 2)]
CPU_TREES = {
    "render": ([("rt.make_renderer", 0), ("rt.render", 0), ("rt.camera", 1),
                ("rt.lanes", 1), ("rt.finalize", 1)], 0),
    "render_f64": ([("rt.make_renderer", 0), ("rt.render", 0),
                    ("rt.camera", 1), ("rt.lanes", 1), ("rt.finalize", 1)],
                   0),
    "train": ([("rt.train_step", 0), ("rt.camera", 1), ("rt.lanes", 1),
               ("rt.lanes", 1), ("rt.finalize", 1), *CHAIN, ("rt.optim", 1)],
              0),
    "stream": ([("rt.stream_step", 0), ("rt.stream.rebuild", 1),
                ("rt.camera", 1), ("rt.lanes", 1), ("rt.lanes", 1),
                ("rt.stream.to_slots", 1), *CHAIN, ("rt.optim", 1)], 0),
}
CARD_TREES = {
    "render": ([("rt.make_renderer", 0), ("rt.render", 0), ("rt.camera", 1),
                ("rt.lanes", 1), ("rt.launch.regen_render", 1),
                ("rt.finalize", 1)], 0),
    "render_f64": ([("rt.make_renderer", 0), ("rt.render", 0),
                    ("rt.camera", 1), ("rt.lanes", 1),
                    ("rt.launch.f64_render", 1), ("rt.finalize", 1)], 0),
    "train": ([("rt.train_step", 0), ("rt.camera", 1), ("rt.lanes", 1),
               ("rt.lanes", 1), ("rt.launch.fused_train", 1),
               ("rt.launch.fused_train_render", 2), ("rt.launch.reverse", 3),
               *[("rt.launch.reduce_rows", 2)] * 3, ("rt.finalize", 1),
               *CHAIN, ("rt.optim", 1)], 0),
    "stream": ([("rt.stream_step", 0), ("rt.stream.rebuild", 1),
                ("rt.camera", 1), ("rt.lanes", 1), ("rt.lanes", 1),
                ("rt.launch.fused_stream", 1), ("rt.launch.stream_train", 2),
                ("rt.records", 2), ("rt.launch.stream_segment_sum", 3),
                *[("rt.launch.reduce_rows", 2)] * 2,
                ("rt.stream.to_slots", 1), *CHAIN, ("rt.optim", 1)], 0),
}


def _one_request(kind, device):
    request = _request(kind, device)
    request()
    trace.reset()
    with trace.recording():
        request()
    return _tree(), trace.counts().get("host_sync", 0)


@pytest.mark.parametrize("kind", sorted(CPU_TREES))
def test_request_span_tree_and_host_syncs(kind):
    assert _one_request(kind, torch.device("cpu")) == CPU_TREES[kind]
    roots = [r for r in trace.records() if r.parent < 0]
    assert sum((r.counts or {}).get("host_sync", 0) for r in roots) == (
        CPU_TREES[kind][1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(CARD_TREES))
def test_request_span_tree_and_host_syncs_on_card(kind, cuda):
    """On the card: each request's tree and its ``host_sync`` count (the
    cells' numbers: none in a render, an rtow train step or a stream
    step), and every synchronisation torch warns of inside an ``rt.sync``
    span: with no ``rt.sync`` in the tree, the request never waits."""
    request = _request(kind, cuda)
    request()
    torch.cuda.synchronize()
    trace.reset()
    outside = []

    def show(message, category, filename, lineno, file=None, line=None):
        # torch notes once that the mode is a prototype: no sync of ours
        prototype = str(message).startswith(
            "Synchronization debug mode is a prototype")
        if trace.innermost() != "rt.sync" and not prototype:
            outside.append(f"{filename}:{lineno} {message}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with trace.recording():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                request()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (_tree(), trace.counts().get("host_sync", 0)) == CARD_TREES[kind]
    assert outside == []
    if kind == "render_f64":     # kernel 6 once, in two levels
        assert trace.counts()["launch.f64_render"] == 1
        assert trace.counts()["launch.group_table"] == 1
        assert trace.counts()["scan.two_level"] == 1
        assert trace.counts().get("scan.one_level", 0) == 0
