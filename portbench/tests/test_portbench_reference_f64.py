"""The double-precision reference (``reference/tracer_f64.py``) against the
port's plain version of the f64 kernel, on the CPU: the same sums and the
same image bit for bit, and its float32 control apart from them."""
from __future__ import annotations

import pytest
import torch

from portbench import port
from portbench import scene as bscene
from portbench.reference import tracer, tracer_f64
from portbench.reference.scenes import DIELECTRIC, METAL
from raytracingincuda_torch.ops import f64_kernel as fk

W, H, SPP, DEPTH = 24, 16, 3, 6
SEED = 2**31 + 11
CAM = dict(vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
           vup=(0.0, 1.0, 0.0), defocus_angle=0.6, focus_dist=10.0)


def _cover():
    return bscene.make({"scene": {"builder": "cover", "args": dict(
        seed=1227, grid=11, pad=128)}}, "cpu")


def _glass_and_metal():
    """60 random spheres in front of the camera, a third metal and a third
    glass, and the first five again in free slots as glass or metal: the
    same sphere twice is an exact tie, which the lower slot wins."""
    t = bscene.make({"scene": {"builder": "random_spheres", "args": dict(
        n_spheres=60, seed=5, half_extent=3.0)}}, "cpu")
    t["mat"][1:61:3] = METAL
    t["fuzz"][1:61:3] = 0.3
    t["mat"][2:61:3] = DIELECTRIC
    t["ior"][2:61:3] = 1.5
    for k in tracer.LEAVES:
        t[k][61:66] = t[k][1:6]
    t["mat"][61:66] = torch.where(t["mat"][1:6] == DIELECTRIC, METAL,
                                  DIELECTRIC)
    t["ior"][61:66] = 1.5
    t["active"][61:66] = True
    return t


def _reference(t, dtype):
    sc = tracer.scene_tensors(t, "cpu", dtype)
    cam = tracer_f64.camera(CAM, W, H, "cpu", dtype)
    return tracer_f64.radiance(sc, cam, SEED, torch.arange(W * H), W, SPP,
                               DEPTH, dtype=dtype)


@pytest.mark.parametrize("make", [_cover, _glass_and_metal])
def test_radiance_bit_equal_to_f64_reference(make):
    t = make()
    inputs = fk.f64_inputs(port.scene(t), port.camera(CAM), W, H)
    plain = fk.f64_reference(*inputs, samples=SPP, max_depth=DEPTH,
                             seed=SEED)[:, :W * H]
    acc, counts = _reference(t, torch.float64)
    assert acc.dtype == torch.float64
    assert torch.equal(acc, plain)
    assert torch.equal(tracer_f64.finish(acc, SPP).t(),
                       fk.finalize(plain.t(), SPP))
    assert counts["samples"] == W * H * SPP
    assert counts["hits"] > 0 and counts["misses"] > 0
    assert counts["rr_draws"] == 0
    control, _ = _reference(t, torch.float32)
    assert control.dtype == torch.float32
    assert float((control.double() - acc).abs().max()) > 0.0
