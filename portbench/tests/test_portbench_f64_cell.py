"""The ``rtow_cover_f64.render`` cell at a tiny size on the CPU: a sound run
is correct, a fault planted on kernel 6's dispatcher is not, its control
fails the limit, and its roofline prices the float work at the FP64 rate."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import control, harness, trace, work, work_f64
from portbench.harness import load_module, metric_file
from portbench.tests.conftest import REPO, SEED, copy_benchmark, edit_json
from raytracingincuda_torch.ops import f64_kernel as fk

CELL = "rtow_cover_f64.render"


@pytest.fixture
def root(tmp_path):
    r = copy_benchmark(tmp_path)
    edit_json(r / "portbench" / "workloads" / f"{CELL}.json",
              lambda d: (d["params"].update(width=24, height=16, samples=2,
                                            bounces=4),
                         d["check"].update(pixels=64, requests=2)))
    return r


def _run(root):
    return harness.run(CELL, SEED, 0.3, False, root=root,
                       device=torch.device("cpu"), t0=time.perf_counter())


def _scaled(orig):
    return lambda *a, **kw: orig(*a, **kw) * (1.0 + 1e-3)


def _half(orig):
    def run(*a, **kw):
        out = orig(*a, **kw).clone()
        out[:, out.shape[1] // 2:] = 0.0
        return out

    return run


def test_sound_run_reads_zero(root):
    out = _run(root)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["checks"]["pixel_max_abs_diff"]["value"] == 0.0
    assert set(out["metrics"]) == {"render_ms", "render_p90_ms", "setup_s"}


@pytest.mark.parametrize("fault", [_scaled, _half])
def test_fault_on_kernel_6_is_not_correct(root, monkeypatch, fault):
    monkeypatch.setattr(fk, "_f64", fault(fk._f64))
    out = _run(root)
    assert out["correct"] is False
    assert out["checks"]["pixel_max_abs_diff"]["value"] > 0.0


def test_control_fails_the_limit(root):
    got = control.readings(CELL, SEED, "control", torch.device("cpu"),
                           root=root, requests=2)
    assert got["pixel_max_abs_diff"] > 0.0


def test_needed_work_at_the_fp64_rate():
    one = {"samples": 1, "hits": 1, "misses": 1, "rr_draws": 0}
    f32 = work.needed(one, pixels=1, slots=512)
    got = work_f64.needed(one, pixels=1, slots=512)
    assert got["fp64_ops"] == f32["fp32_ops"]
    assert got["int32_ops"] == f32["int32_ops"] == 3 * 112
    assert got["bytes"] == 512 * 11 * 4 + 3 * 8
    big = {"fp64_ops": 34e12 * 1e-3, "int32_ops": 1.0, "bytes": 1.0}
    assert work_f64.least_seconds(big) == pytest.approx(1e-3)


def test_roofline_reader():
    t = SimpleNamespace(requests=2, kernels=frozenset({"f64_kernel"}), ops=[
        SimpleNamespace(name="void (anonymous namespace)::f64_kernel<false>"
                        "(Params)", start_us=0.0, end_us=4000.0)])
    assert trace.kernel_ms(t) == pytest.approx(2.0)
    read = load_module(metric_file(REPO / "portbench", "f64_roofline"),
                       "metric").read
    rec = SimpleNamespace(trace=t, work=None)
    assert read(rec) is None                      # no work counted
    rec.work = {"fp64_ops": 34e12 * 1e-3, "int32_ops": 0.0, "bytes": 0.0}
    assert read(rec) == pytest.approx(50.0)
    assert read(SimpleNamespace(trace=None, work=rec.work)) is None
