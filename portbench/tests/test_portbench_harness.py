"""The harness on the CPU at tiny sizes: the result line, a cell, a
configuration and a metric added as files alone, the command without a
card, and the import fence."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import CELLS, REPO, SEED, copy_benchmark, edit_json

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
TRACE_KEYS = LINE_KEYS | {"breakdown"}
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def _run(root, name, trace=False, seconds=0.3):
    import time

    return harness.run(name, SEED, seconds, trace, root=root,
                       device=torch.device("cpu"), t0=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_line_carries_the_contract_keys(tiny_root, name):
    out = _run(tiny_root, name)
    assert set(out) == LINE_KEYS and list(out)[-1] == "checks"
    assert set(out["device"]) == DEVICE_KEYS
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if name in m.get("workloads", [name])}
    assert set(out["metrics"]) == want
    assert out["attempted"] >= 1 and out["failed"] == 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert out["correct"], out["checks"]


def test_traced_line(tiny_root):
    out = _run(tiny_root, "rtow_cover.render", trace=True)
    assert set(out) == TRACE_KEYS and list(out)[-1] == "checks"
    assert set(out["device"]) == DEVICE_KEYS | {"busy_s", "window_s"}
    assert out["metrics"] == {}       # no device op runs on the CPU
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_cell_config_and_metric_added_as_files(tiny_root):
    base = tiny_root / "portbench"
    cfg = json.loads((base / "configs" / "rtow_cover.json").read_text())
    cfg["name"] = "rtow_small"
    cfg["scene"]["args"].update(seed=5, grid=3)
    (base / "configs" / "rtow_small.json").write_text(json.dumps(cfg))
    cell = json.loads((base / "workloads" / "rtow_cover.render.json"
                       ).read_text())
    cell.update(config="rtow_small", traffic="render_rr")
    cell["params"].update(rr_start=1)
    (base / "workloads" / "rtow_small.render_rr.json").write_text(
        json.dumps(cell))
    (base / "metrics" / "requests_done.py").write_text(
        "def read(rec):\n    return rec.completed\n")

    def add(d):
        d["configs"].append({"name": "rtow_small", "source": "test",
                             "file": "portbench/configs/rtow_small.json",
                             "reduced": [], "why": "test"})
        d["workloads"].append({"name": "rtow_small.render_rr",
                               "config": "rtow_small", "traffic": "render_rr",
                               "chips": 1, "why": "test"})
        for m in d["end_to_end"]:
            if "render_ms" in m["name"]:
                m["workloads"].append("rtow_small.render_rr")
        d["per_layer"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "render_ms",
                               "workloads": ["rtow_small.render_rr"]})

    edit_json(tiny_root / "BENCHMARK.json", add)
    out = _run(tiny_root, "rtow_small.render_rr")
    assert out["correct"] and "render_ms" in out["metrics"]
    traced = _run(tiny_root, "rtow_small.render_rr", trace=True)
    assert traced["metrics"]["requests_done"]["value"] == traced["attempted"]


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_command_refuses_without_a_card():
    cmd = json.loads((REPO / "BENCHMARK.json").read_text())["command"]
    res = subprocess.run([sys.executable, *cmd[1:], "--workload",
                          "rtow_cover.render", "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_command_fails_with_the_benchmark_alone(tmp_path):
    root = copy_benchmark(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    cmd = json.loads((REPO / "BENCHMARK.json").read_text())["command"]
    res = subprocess.run([sys.executable, *cmd[1:], "--workload",
                          "rtow_cover.render", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


FENCED = {"jax", "jaxlib", "flax", "raytracingincuda_tpu"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_import_fence_in_the_sources():
    files = sorted((REPO / "portbench").rglob("*.py"))
    assert files
    for f in files:
        tops = _imports(f)
        assert not tops & FENCED, f
        if "reference" in f.relative_to(REPO / "portbench").parts:
            assert "raytracingincuda_torch" not in tops, f
        if "tests" not in f.parts:
            assert "benchmarks/" not in f.read_text(), f


def test_import_fence_at_run_time(tiny_root):
    code = ("import time, torch, sys\n"
            "from pathlib import Path\n"
            "from portbench import harness\n"
            f"harness.run('rtow_cover.render', {SEED}, 0.2, False, "
            f"root=Path({str(tiny_root)!r}), device=torch.device('cpu'), "
            "t0=time.perf_counter())\n"
            "print(harness.fenced_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_fence_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raytracingincuda_tpu_x", None)
    monkeypatch.setitem(sys.modules, "jaxlib_like.sub", None)
    assert harness.fenced_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", None)
    assert harness.fenced_modules() == ["jax"]
