"""The benchmark's streamed cells through its harness on the CPU, at tiny
sizes, and the reader of ``scene_ms.stream``.

``random_1m.stream_train`` and ``random_100k.stream_render`` run end to
end (set-up, the window, the check) on a copy of the benchmark as
``portbench/tests/conftest.py`` makes one, each cut to a size the CPU
traces in seconds; the limits stay the cells' own. The stream render's
check leaves out the pixels whose paths meet an exact tie of the closest
hit (``portbench/reference/ties.py``): a scene with a sphere twice marks
the pixels that see it, and only those. ``scene_ms.stream`` is read from
synthetic span records, with the syncs nested in its spans subtracted,
and reads nothing from a port without the ``rt.stream.to_slots`` span.
"""
from __future__ import annotations

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, spans, trace
from portbench.reference import scenes, ties, tracer
from portbench.tests.conftest import REPO, SEED, copy_benchmark, edit_json

TINY = {
    "random_1m.stream_train": (dict(width=32, height=20, fit_steps=3),
                               dict(pixels=64, steps=2)),
    "random_100k.stream_render": (dict(width=32, height=20, samples=2,
                                       bounces=4), dict(pixels=64,
                                                        requests=2)),
}
# enough spheres that both scenes take the streamed route (above 4096
# slots), few enough for the CPU
SPHERES = {"random_1m": 3000, "random_100k": 5000}


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(1)
    root = copy_benchmark(tmp_path)
    for name, (params, check) in TINY.items():
        edit_json(root / "portbench" / "workloads" / f"{name}.json",
                  lambda d: (d["params"].update(params),
                             d["check"].update(check)))
    for name, n in SPHERES.items():
        edit_json(root / "portbench" / "configs" / f"{name}.json",
                  lambda d: d["scene"]["args"].update(n_spheres=n))
    return root


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("traced", [False, True])
def test_new_cell_runs_end_to_end(root, name, traced):
    out = harness.run(name, SEED, 0.2, traced, root=root,
                      device=torch.device("cpu"), t0=time.perf_counter())
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"], out["checks"]
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if name in m.get("workloads", [name])}
    # no device operation runs on the CPU, so no per-layer metric reads
    assert set(out["metrics"]) == (set() if traced else want)


def test_stream_render_prepares_once(root, monkeypatch):
    """The stream render cell prepares its stream in set-up alone: the
    window's requests reuse it."""
    from raytracingincuda_torch.ops import stream_kernel as sk

    calls = []
    orig = sk.prepare_stream_scene
    monkeypatch.setattr(sk, "prepare_stream_scene",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    out = harness.run("random_100k.stream_render", SEED, 0.2, False,
                      root=root, device=torch.device("cpu"),
                      t0=time.perf_counter())
    assert out["attempted"] >= 1 and len(calls) == 1


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_stream_render_check_catches_a_fault_in_kernel_4(root, monkeypatch,
                                                          fault):
    """``faults.py``'s render faults planted on the stream route's
    dispatcher: the image scaled by 1 + 1e-3, or the second half of the
    lanes left black. The check comes out not correct."""
    from portbench import faults
    from raytracingincuda_torch.ops import stream_kernel as sk

    make = {"altered": lambda o: faults._scaled(o, 1.0 + 1e-3, False),
            "half_batch": faults._half_regen}[fault]
    monkeypatch.setattr(sk, "_stream", make(sk._stream))
    out = harness.run("random_100k.stream_render", SEED, 0.2, False,
                      root=root, device=torch.device("cpu"),
                      t0=time.perf_counter())
    assert out["correct"] is False, out["checks"]


def test_stream_render_check_leaves_out_the_ties(root, monkeypatch, capsys):
    """The ground sphere copied into a free slot: every ray that hits the
    ground meets a tie, so the check leaves those pixels out (and says how
    many) and compares the rest exactly."""
    plain = scenes.BUILDERS["random_spheres"]

    def twice(**kw):
        out = {k: v.copy() for k, v in plain(**kw).items()}
        free = int(np.flatnonzero(~out["active"])[0])
        for v in out.values():
            v[free] = v[0]
        return out

    monkeypatch.setitem(scenes.BUILDERS, "random_spheres", twice)
    out = harness.run("random_100k.stream_render", SEED, 0.2, False,
                      root=root, device=torch.device("cpu"),
                      t0=time.perf_counter())
    assert out["correct"], out["checks"]
    said = [ln for ln in capsys.readouterr().err.splitlines()
            if "met an exact tie" in ln]
    assert len(said) == 1 and 0 < int(said[0].split()[1]) < 64, said


CAMERA = json.loads((REPO / "portbench" / "configs" / "random_100k.json"
                     ).read_text())["camera"]


def test_ties_mark_only_the_pixels_that_meet_one():
    """The cover scene at grid 2 (20 spheres): no tie, so the marked trace
    is the plain one bit for bit. With the large metal sphere copied into
    a free slot, every ray that hits it meets a tie (one root in two
    slots): those pixels read NaN, the others the plain trace's bits."""
    arrays = scenes.cover(grid=2)
    cam = tracer.camera(CAMERA, 16, 10, "cpu")
    pix = torch.arange(160)

    def both(arrays):
        sc = tracer.scene_tensors(arrays, "cpu")
        return (tracer.radiance(sc, cam, 5, pix, 16, 2, 4)[0],
                ties.radiance(sc, cam, 5, pix, 16, 2, 4)[0])

    plain, marked = both(arrays)
    assert torch.equal(plain, marked)
    twice = {k: v.copy() for k, v in arrays.items()}
    for k, v in twice.items():
        v[20] = v[19]
    plain2, marked2 = both(twice)
    assert torch.equal(plain2, plain)           # the lower slot wins a tie
    clear = torch.isfinite(marked2).all(0)
    assert 0 < int((~clear).sum()) < 160
    assert torch.equal(marked2[:, clear], plain[:, clear])
    assert torch.isnan(marked2[:, ~clear]).all()


US = 1000      # ns


def rec(name, start_us, end_us, parent=-1):
    return SimpleNamespace(name=name, start_ns=start_us * US,
                           end_ns=end_us * US, parent=parent, counts=None)


def records(to_slots=True):
    """The untimed first step (0-100 us), then two steps of the window
    (200-1200, 1300-2300), each: the rebuild (100 us, a 20 us sync inside),
    the map to slots (30 us), the chain (its scene part 200 us), the
    optimizer (150 us, a 50 us sync two levels down)."""
    out = [rec("rt.stream_step", 0, 100)]
    for t0 in (200, 1300):
        root = len(out)
        out += [rec("rt.stream_step", t0, t0 + 1000),
                rec("rt.stream.rebuild", t0 + 10, t0 + 110, root),
                rec("rt.sync", t0 + 50, t0 + 70, root + 1)]
        if to_slots:
            out.append(rec("rt.stream.to_slots", t0 + 500, t0 + 530, root))
        chain = len(out)
        out += [rec("rt.chain", t0 + 540, t0 + 800, root),
                rec("rt.chain.scene", t0 + 550, t0 + 750, chain)]
        optim = len(out)
        out += [rec("rt.optim", t0 + 820, t0 + 970, root),
                rec("rt.launch.adam", t0 + 830, t0 + 900, optim),
                rec("rt.sync", t0 + 840, t0 + 890, optim + 1)]
    return out


def _read(monkeypatch, recs):
    monkeypatch.setattr(spans, "_registry", lambda: SimpleNamespace(
        records=lambda: recs))
    t = trace.Trace(window_s=2e-3, busy_s=0.0, requests=2,
                    ops=[trace.DeviceOp("k", 250, 500)], gaps=[],
                    kernels=frozenset())
    return harness.load_module(
        harness.metric_file(REPO / "portbench", "scene_ms.stream"),
        "metric").read(SimpleNamespace(trace=t, work=None))


def test_scene_ms_reader_subtracts_nested_syncs(monkeypatch):
    """A request: rebuild 100 - 20, to_slots 30, the chain's scene part
    200, the optimizer 150 - 50: 0.41 ms."""
    assert _read(monkeypatch, records()) == pytest.approx(0.41)


def test_scene_ms_reader_without_the_span(monkeypatch):
    assert _read(monkeypatch, records(to_slots=False)) is None
    monkeypatch.setattr(spans, "_registry", lambda: None)
    assert harness.load_module(
        harness.metric_file(REPO / "portbench", "scene_ms.stream"),
        "metric").read(SimpleNamespace(trace=None, work=None)) is None
