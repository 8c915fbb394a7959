#!/usr/bin/env python3
"""Count, on the CPU, the sphere tests that a warp-coherent two-level scan
would run for kernel 1, against the brute-force scan's one test per slot.

    python3 probes/cull_count.py [--rows 150 400 650] [--samples 100]
        [--group 16 32] [--rr 2]

The plain version's rays at the headline (scene 1, 1280x768, 25 bounces,
``--samples`` samples, parity or ``--rr``) on the rows ``--rows``: the
regenerating recurrence of ``render_kernel._regen_lanes`` with a closest
hit that records every wave's rays, so that a wave is one iteration of
kernel 1's loop and a warp is 32 consecutive lanes of a row. The two-level
scan per ray: the ground and the three large spheres first (their closest
hit is the lane's t_cur), then groups of ``--group`` small spheres (Morton
order of their centres), each behind a conservative bound sphere (the
stream scenes' bound: the centres' box centre, the largest centre distance
plus the radius, 1e-4 of slack), walked front to back from the camera; a
lane can improve in a group when its ray meets the bound before t_cur, and
t_cur then falls to the group's closest hit. A warp tests a group when any
of its lanes that trace this wave can improve in it. Counted in float64
(a count, not the kernel's arithmetic): per warp iteration, 4 + one bound
test per group + the group's size per group tested, against the
brute-force scan's slots (512). Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

T_MIN = 1e-3


def roots(c, r, o, d):
    """(rays, spheres) float64 nearest root t > T_MIN of each ray with each
    sphere (inf where none): the numerator-domain test of ops/intersect.py."""
    oc = c[None, :, :] - o[:, None, :]
    a = (d * d).sum(1)[:, None]
    h = (d[:, None, :] * oc).sum(2)
    cc = (oc * oc).sum(2) - r[None, :] ** 2
    disc = h * h - a * cc
    sq = np.sqrt(np.where(disc > 0, disc, 0.0))
    near, far = (h - sq) / a, (h + sq) / a
    t = np.where(near > T_MIN, near, far)
    return np.where((disc > 0) & (t > T_MIN), t, np.inf)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="*", default=[150, 400, 650])
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--group", type=int, nargs="*", default=[16, 32])
    ap.add_argument("--rr", type=int, default=None)
    args = ap.parse_args()

    from raytracingincuda_torch.models.camera import CameraConfig, initialize
    from raytracingincuda_torch.models.scene import build_scene
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops.intersect import hit_world
    from raytracingincuda_torch.ops.stream_kernel import _morton3

    torch.set_num_threads(4)
    w, h, depth = 1280, 768, 25
    cam_cfg = CameraConfig.reference_default()
    scene = build_scene(1)
    m = rk.pack_scene_matrix(scene).numpy().astype(np.float64)
    act = m[:, rk.COL_ACTIVE] > 0.5
    c_all, r_all = m[:, 0:3], m[:, rk.COL_RADIUS]
    big = np.flatnonzero(act & (np.abs(r_all) > 0.5))
    small = np.flatnonzero(act & (np.abs(r_all) <= 0.5))
    c = c_all[small]
    lo, span = c.min(0), np.maximum(c.max(0) - c.min(0), 1e-9)
    q = np.clip((c - lo) / span * 1023.0, 0, 1023).astype(np.uint32)
    small = small[np.argsort(_morton3(q), kind="stable")]
    center = np.array([float(v) for v in initialize(cam_cfg, w, h).center])

    rays = []

    def record(o, d, active):
        hr = hit_world(scene, o, d)
        rays.append((torch.stack([o.x, o.y, o.z], 1).double().numpy(),
                     torch.stack([d.x, d.y, d.z], 1).double().numpy(),
                     active.numpy().copy()))
        return hr

    ids = torch.cat([torch.arange(w, dtype=torch.int32) + row * w
                     for row in args.rows])
    fi = (ids % w).float()
    fj = torch.div(ids, w, rounding_mode="floor").float()
    budget = torch.full(ids.shape, float(args.samples))
    cam = rk.unpack_camera(rk.pack_camera(initialize(cam_cfg, w, h)))
    rk._regen_lanes(ids, fi, fj, budget, rk.scene_from_matrix(
        rk.pack_scene_matrix(scene)), cam, samples=args.samples,
        max_depth=depth, seed=1227, legacy_sky=False, emit_depth=True,
        rr_start=args.rr, sample_offset=0, finalize_scale=None,
        hit_fn=record)

    res = {"rows": args.rows, "samples": args.samples, "rr_start": args.rr,
           "slots": int(m.shape[0]), "active": int(act.sum()),
           "large": len(big), "small": len(small), "waves": len(rays),
           "groups": {}}
    for g in args.group:
        groups = [small[k:k + g] for k in range(0, len(small), g)]
        bounds = []
        for grp in groups:
            cc = c_all[grp]
            ctr = (cc.min(0) + cc.max(0)) * 0.5
            rb = np.sqrt(((cc - ctr) ** 2).sum(1)).max() + np.abs(
                r_all[grp]).max()
            bounds.append((ctr, rb * 1.0001 + 1e-4))
        order = np.argsort([np.linalg.norm(b[0] - center) - b[1]
                            for b in bounds], kind="stable")
        warp_iters = 0
        two_level = 0
        lane_groups = 0
        lane_segments = 0
        for o, d, active in rays:
            t_cur = roots(c_all[big], r_all[big], o, d).min(1)
            tested = np.zeros((o.shape[0] // 32, len(groups)), bool)
            for j in order:
                bc, br = bounds[j]
                oc = bc[None] - o
                a = (d * d).sum(1)
                hh = (d * oc).sum(1)
                disc = hh * hh - a * ((oc * oc).sum(1) - br * br)
                sq = np.sqrt(np.where(disc > 0, disc, 0.0))
                can = (active & (disc > 0) & ((hh + sq) / a > T_MIN)
                       & ((hh - sq) / a < t_cur))
                tested[:, j] = can.reshape(-1, 32).any(1)
                lane_groups += int(can.sum())
                if can.any():
                    tg = roots(c_all[groups[j]], r_all[groups[j]], o[can],
                               d[can]).min(1)
                    t_cur[can] = np.minimum(t_cur[can], tg)
            live = active.reshape(-1, 32).any(1)
            warp_iters += int(live.sum())
            two_level += int((4 + len(groups) + g * tested[live].sum(1)).sum())
            lane_segments += int(active.sum())
        res["groups"][g] = {
            "groups": len(groups), "warp_iterations": warp_iters,
            "tests_per_warp_iteration": two_level / warp_iters,
            "vs_brute_force": two_level / warp_iters / m.shape[0],
            "groups_a_lane_opens_per_segment": lane_groups / lane_segments}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
