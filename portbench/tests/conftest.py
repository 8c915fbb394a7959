"""Fixtures of the benchmark's CPU tests: a copy of the benchmark (its
``BENCHMARK.json`` and ``portbench/``) with every cell cut to a size the
CPU traces in seconds; the limits stay the cells' own."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
CELLS = ("rtow_cover.render", "random_100k.stream_train", "rtow_cover.train",
         "rtow_cover.render_8k")
TINY = {
    "rtow_cover.render": (dict(width=32, height=20, samples=2, bounces=4),
                          dict(pixels=64, requests=2)),
    "rtow_cover.render_8k": (dict(width=40, height=24, samples=1, bounces=3),
                             dict(pixels=64, requests=2)),
    "rtow_cover.train": (dict(width=32, height=20, samples=2, bounces=4,
                              fit_steps=3), dict(pixels=64, steps=2)),
    "random_100k.stream_train": (dict(width=32, height=20, samples=2,
                                      bounces=4, fit_steps=3),
                                 dict(pixels=64, steps=2)),
}
# a seed above 32 bits, as the driver's are
SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def copy_benchmark(dst: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def edit_json(path: Path, fn) -> None:
    d = json.loads(path.read_text())
    fn(d)
    path.write_text(json.dumps(d))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark with each cell tiny and 400 spheres in
    ``random_100k``."""
    root = copy_benchmark(tmp_path)
    for name, (params, check) in TINY.items():
        edit_json(root / "portbench" / "workloads" / f"{name}.json",
                  lambda d: (d["params"].update(params),
                             d["check"].update(check)))
    edit_json(root / "portbench" / "configs" / "random_100k.json",
              lambda d: d["scene"]["args"].update(n_spheres=400))
    return root
