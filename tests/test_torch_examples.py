"""The port's pose examples run as a user runs them, at smoke shapes.

Twins of ``tests/test_examples.py``'s pose cases: each example's
``__main__`` runs as a subprocess on the CPU (the kernels' plain
versions). The point is the surface a user calls (flags, the loop's
wiring, the progress lines), not convergence: exit code 0 (converged)
and 1 (ran clean, tolerance not reached at smoke shapes) both pass.
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [
    ("pose_recovery",
     ["--width", "32", "--height", "20", "--samples", "2", "--bounces", "3",
      "--perturb", "0.1", "--fd_steps", "3", "--device", "cpu"],
     "stage 2"),
    ("pose_recovery",
     ["--width", "32", "--height", "20", "--samples", "2", "--bounces", "3",
      "--perturb", "0.6", "--soft_steps", "3", "--fd_steps", "1",
      "--device", "cpu"],
     "stage 1"),
    ("joint_recovery",
     ["--width", "32", "--height", "20", "--samples", "2", "--bounces", "3",
      "--iters", "2", "--pose_warmup", "1", "--scene_steps", "1",
      "--perturb", "0.05", "--device", "cpu"],
     "iter"),
]


@pytest.mark.parametrize("module,args,marker", CASES,
                         ids=["pose_fd", "pose_soft_then_fd", "joint"])
def test_example_smoke(module, args, marker, tmp_path):
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                           if p)
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", f"raytracingincuda_torch.examples.{module}",
         *args],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert res.returncode in (0, 1), (
        f"{module} crashed (rc={res.returncode}):\n"
        f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    out = (res.stdout + res.stderr).lower()
    assert marker in out, f"{module} printed no progress:\n{out[-2000:]}"
    assert ("recovered" in out or "final" in out), out[-2000:]
    assert ("ok" in res.stdout.lower().split()
            or "not converged" in res.stdout.lower())
