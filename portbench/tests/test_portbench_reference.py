"""The frozen reference against the port's plain versions, and its scene
builders against the port's factories, on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import sampler, scenes, tracer
from raytracingincuda_torch.models.camera import CameraConfig
from raytracingincuda_torch.models.scene import (build_random_scene,
                                                 build_scene, param_leaves)
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import stream_kernel as sk

CAM = dict(vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
           vup=(0.0, 1.0, 0.0), defocus_angle=0.6, focus_dist=10.0)


def _same_arrays(arrays, scene):
    for k, t in zip(tracer.LEAVES, param_leaves(scene.params)):
        assert torch.equal(torch.as_tensor(arrays[k]).float(), t), k
    assert np.array_equal(arrays["mat"], scene.mat_type.numpy())
    assert np.array_equal(arrays["active"], scene.active.numpy())


def test_builders_equal_the_port_factories():
    _same_arrays(scenes.cover(), build_scene(1, device="cpu"))
    _same_arrays(scenes.random_spheres(300, 3),
                 build_random_scene(300, seed=3, device="cpu"))


def _sampled_lanes(inputs, pix):
    n = pix.numel()
    padded = -(-n // rk.PAD) * rk.PAD
    sub = [t[pix].contiguous() for t in inputs[:4]]
    return [torch.cat([t, t[:1].repeat(padded - n)]) for t in sub], n


@pytest.mark.parametrize("rr_start", [None, 2])
def test_radiance_bit_equal_to_regen_reference(rr_start):
    w, h, spp, depth = 48, 30, 3, 8
    scene = build_scene(1, device="cpu")
    inputs = rk.regen_inputs(scene, CameraConfig.reference_default(), w, h,
                             spp)
    pix = torch.from_numpy(np.sort(np.random.default_rng(5).choice(
        w * h, 200, replace=False)))
    lanes, n = _sampled_lanes(inputs, pix)
    seed = 2**31 + 7
    plain = rk.regen_reference(*lanes, *inputs[4:], samples=spp,
                               max_depth=depth, rr_start=rr_start, seed=seed,
                               finalize_scale=1.0 / spp)[:, :n]
    sc = tracer.scene_tensors(scenes.cover(), "cpu")
    acc, counts = tracer.radiance(sc, tracer.camera(CAM, w, h, "cpu"), seed,
                                  pix, w, spp, depth, rr_start=rr_start)
    got = tracer.gamma2(acc * sampler.f32(1.0 / spp))
    assert torch.equal(got, plain)
    assert counts["samples"] == 200 * spp
    assert counts["hits"] > 0 and counts["misses"] > 0
    assert (counts["rr_draws"] > 0) == (rr_start is not None)


def test_radiance_equals_the_stream_reference():
    """The brute-force scan gives the streamed walk's image (ties between
    blocks aside, none here)."""
    w, h, spp, depth = 40, 24, 2, 6
    scene = build_random_scene(300, seed=3, device="cpu")
    stream = sk.prepare_stream_scene(scene, block=64)
    cam_row = rk.pack_camera(rk.initialize(CameraConfig.reference_default(),
                                           w, h))
    ids, ii, jj, budget = rk._lane_setup(w, h, None, spp, 0, None, "cpu")
    plain = sk.stream_reference(ids, ii, jj, budget, stream.scene_mat,
                                stream.bounds, cam_row, block=stream.block,
                                samples=spp, max_depth=depth,
                                finalize_scale=1.0 / spp)[:, :w * h]
    sc = tracer.scene_tensors(scenes.random_spheres(300, 3), "cpu")
    pix = torch.arange(w * h)
    acc, _ = tracer.radiance(sc, tracer.camera(CAM, w, h, "cpu"), 1227, pix,
                             w, spp, depth)
    assert torch.equal(tracer.gamma2(acc * sampler.f32(1.0 / spp)), plain)


def test_reference_gradient_matches_the_port_plain_gradient():
    """The reference's detached-sampler gradient of a pixel-weighted sum
    equals the port's plain gradient (kernel A's plain version) to f32
    summation order."""
    from raytracingincuda_torch.ops import train_kernel as tk

    w, h, spp, depth = 24, 16, 2, 6
    scene = build_scene(1, device="cpu")
    inputs = rk.regen_inputs(scene, CameraConfig.reference_default(), w, h,
                             spp)
    g = torch.zeros((3, inputs[0].shape[0]))
    g[:, :w * h] = torch.rand((3, w * h), generator=torch.Generator()
                              .manual_seed(3))
    d_scene, _ = tk.grad_reference(inputs[0], inputs[1], inputs[2],
                                   g.contiguous(), inputs[4], inputs[5],
                                   samples=spp, max_depth=depth, rr_start=1)
    sc = tracer.scene_tensors(scenes.cover(), "cpu", requires_grad=True)
    acc, _ = tracer.radiance(sc, tracer.camera(CAM, w, h, "cpu"), 1227,
                             torch.arange(w * h), w, spp, depth, rr_start=1)
    grads = torch.autograd.grad((acc * g[:, :w * h]).sum(),
                                [sc[k] for k in tracer.LEAVES])
    for k, (got, col) in enumerate(zip(grads, range(9))):
        want = d_scene[:, col]
        scale = float(want.abs().max()) + 1e-30
        assert float((got - want).abs().max()) <= 1e-4 * scale, tracer.LEAVES[k]
