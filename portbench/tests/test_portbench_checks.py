"""What decides ``correct``: the control (the reference in bfloat16 in
the port's place) and each fault a cell can have, planted under the timed
path of a whole run (the look for a card skipped), come out not correct
under the cells' own limits; sound runs come out correct."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import control, faults, harness
from portbench.tests.conftest import SEED

RENDERS = ("rtow_cover.render", "rtow_cover.render_8k")
TRAINS = ("rtow_cover.train", "random_100k.stream_train")
CASES = ([(c, "altered") for c in RENDERS + TRAINS]
         + [(c, "half_batch") for c in RENDERS + TRAINS]
         + [(c, f) for c in TRAINS
            for f in ("state_unchanged", "params_unchanged")])


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_under_a_run_is_not_correct(tiny_root, name, fault):
    with faults.planted(fault):
        out = harness.run(name, SEED, 0.3, False, root=tiny_root,
                          device=torch.device("cpu"), t0=time.perf_counter())
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", RENDERS + TRAINS)
def test_control_fails_a_limit(tiny_root, name):
    cell = harness.load_cell(tiny_root, name)
    limits = cell.cell["check"]["limits"]
    got = control.readings(name, SEED, "control", torch.device("cpu"),
                           root=tiny_root)
    assert any(got[k] > limits[k] for k in limits), got
    sound = control.readings(name, SEED, "sound", torch.device("cpu"),
                             root=tiny_root)
    assert all(sound[k] <= limits[k] for k in limits), sound
