#!/usr/bin/env python3
"""Time the stream train step's kernels on one CUDA card, for comparing
trees of the port on the same card in one call.

    PYTHONPATH=<tree> python3 probes/stream_step.py --tag NAME
        [--dump FILE | --compare FILE] [--scale]

The package is imported from ``PYTHONPATH``, so one call can time several
checkouts (parent, change, change, parent). At ``chip_smoke.py`` phase
12's cell (100k random spheres, seed 3, 640x384, 4 spp, 10 bounces, MSE)
it measures: ``make_stream_train``'s fused step (a warm-up, then 3 steps
in CUDA events) and peak memory; the ``fused=False`` step (a warm-up,
then 3); on the step's records, ``record_order``, the segmented sum and
``index_add_`` (5 calls each); kernel 5 (both modes) and kernel 4 on the
step's stream at 640x384x1spp/3b; the warp-union count where the tree has
``walk_counts``; with ``--scale``, one fused step at 1M spheres (1 spp, 6
bounces) and its peak memory. ``--dump`` saves the 100k step's written
records keyed by (lane, sample, bounce), whatever the tree's record
layout; ``--compare`` checks them against such a file bit for bit. Prints
one JSON line and writes it to ``chiprun_out/stream_step_<tag>.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch


def timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def canonical(stk, rec_row, rec_val, padded, samples, depth):
    """The written records as (index in (lane, sample, bounce) order, row,
    nine values), sorted by that index."""
    idx = torch.arange(rec_row.shape[0], device=rec_row.device)
    if hasattr(stk, "TILE"):    # ((sample, bounce), lane)
        lane, sb = idx % padded, idx // padded
        key = lane * samples * depth + sb
    else:                       # (lane, sample, bounce)
        key = idx
    w = rec_row >= 0
    order = torch.argsort(key[w])
    return (key[w][order].cpu(), rec_row[w][order].cpu(),
            rec_val[w][order].cpu())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--dump")
    ap.add_argument("--compare")
    ap.add_argument("--scale", action="store_true")
    args = ap.parse_args()

    import raytracingincuda_torch
    from raytracingincuda_torch.models.camera import CameraConfig, initialize
    from raytracingincuda_torch.models.scene import Scene, build_random_scene
    from raytracingincuda_torch.ops import grad as gradlib
    from raytracingincuda_torch.ops import kernel_io as kio
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import stream_kernel as sk
    from raytracingincuda_torch.ops import stream_train_kernel as stk
    from raytracingincuda_torch.ops import train_kernel as tk
    from raytracingincuda_torch.ops.rng import DEFAULT_SEED
    from raytracingincuda_torch.ops.stream_kernel import StreamScene
    from raytracingincuda_torch.utils.timing import RenderTimer

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    res = {"tag": args.tag, "card": card,
           "package": str(Path(raytracingincuda_torch.__file__).parent)}
    cam = CameraConfig.reference_default()
    w, h, spp, bounces = 640, 384, 4, 10
    s100k = build_random_scene(100_000, seed=3, device=dev)
    gen = torch.Generator().manual_seed(5)
    target = torch.rand((h, w, 3), generator=gen).to(dev)
    stream = sk.prepare_stream_scene(s100k)
    for fused in (True, False):
        init_fn, step_fn = gradlib.make_stream_train(stream, w, h, spp,
                                                     bounces, fused=fused)
        state0 = init_fn(s100k.params)
        torch.cuda.reset_peak_memory_stats()
        step_fn(state0, cam, s100k.mat_type, s100k.active, target)
        times = []
        for _ in range(3):
            with RenderTimer(dev) as t:
                step_fn(state0, cam, s100k.mat_type, s100k.active, target)
            times.append(t.ms)
        name = "fused" if fused else "two_program"
        res[f"{name}_step_ms"] = times
        res[f"{name}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    border = gradlib.front_to_back_border(stream, cam, w, h)
    st0 = StreamScene(*sk.build_stream_arrays(
        Scene(state0.params, s100k.mat_type, s100k.active), stream.perm,
        stream.block, stream.scene_mat.shape[0], border=border),
        stream.block, stream.perm)
    ids, ii, jj, _ = kio.lane_setup(w, h, None, spp, 0, None, dev)
    row = rk.pack_camera(initialize(cam, w, h)).to(dev)
    rows = kio.lane_rows(target, ids, w * h)
    _, rec_row, rec_val, _, _ = stk.train_records(
        ids, ii, jj, rows, st0.scene_mat, st0.bounds, row, block=st0.block,
        samples=spp, max_depth=bounces, seed=DEFAULT_SEED, rr_start=None,
        sample_offset=0, fused=True, num_pixels=w * h)
    if args.dump or args.compare:
        got = canonical(stk, rec_row, rec_val, ids.shape[0], spp, bounces)
        if args.dump:
            torch.save(got, args.dump)
        else:
            want = torch.load(args.compare)
            res["records_compared"] = int(got[0].shape[0])
            res["records_bit_equal"] = all(
                a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(got, want))
    (keys, src), order_ms = timed(lambda: stk.record_order(rec_row), 5)
    n_rows = st0.scene_mat.shape[0]
    _, seg_ms = timed(lambda: stk.segment_sum_kernel(keys, src, rec_val,
                                                     n_rows), 5)
    lib_vals, lib_keys = rec_val[src], keys.long()
    out = torch.zeros((n_rows, kio.GRAD_COLS), device=dev)
    _, lib_ms = timed(lambda: out.zero_().index_add_(0, lib_keys, lib_vals),
                      5)
    res.update(records=int(keys.shape[0]), record_order_ms=order_ms,
               segment_sum_ms=seg_ms, index_add_ms=lib_ms)
    del rec_row, rec_val, keys, src, lib_vals
    # kernels 4 and 5 on the step's stream at 640x384x1spp/3b
    ids, ii, jj, bud = kio.lane_setup(w, h, None, 1, 0, None, dev)
    rows = kio.lane_rows(target, ids, w * h)
    g = (torch.randn((3, ids.shape[0]), generator=torch.Generator()
                     .manual_seed(6)) * 1e-3).to(dev)
    a5 = (ids, ii, jj, rows, st0.scene_mat, st0.bounds, row)
    kw = dict(block=st0.block, samples=1, max_depth=3, rr_start=None)
    _, res["kernel5_fused_ms"] = timed(lambda: stk.fused_stream_kernel(
        *a5, num_pixels=w * h, loss="mse", gamma=False, **kw), 3)
    _, res["kernel5_grads_ms"] = timed(lambda: stk.stream_grads_kernel(
        ids, ii, jj, g, *a5[4:], **kw), 3)
    _, res["kernel4_ms"] = timed(lambda: sk.stream_kernel(
        ids, ii, jj, bud, st0.scene_mat, st0.bounds, row, **kw), 3)
    if hasattr(stk, "walk_counts"):
        ids, ii, jj, _ = kio.lane_setup(w, h, None, spp, 0, None, dev)
        opened, fetched = stk.walk_counts(ids, ii, jj, st0.scene_mat,
                                          st0.bounds, row, block=st0.block,
                                          samples=spp, max_depth=bounces)[:2]
        res["opened_per_lane_sum"] = int(opened.long().sum())
        res["fetched_per_warp_sum"] = int(fetched.long().sum())
    if args.scale:
        del st0, stream, s100k
        s1m = build_random_scene(1_000_000, seed=3, half_extent=60.0,
                                 device=dev)
        st1m = sk.prepare_stream_scene(s1m)
        init_fn, step_fn = gradlib.make_stream_train(st1m, w, h, 1, 6)
        state0 = init_fn(s1m.params)
        tgt = torch.rand((h, w, 3), generator=gen).to(dev)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2):
            with RenderTimer(dev) as t:
                step_fn(state0, cam, s1m.mat_type, s1m.active, tgt)
            times.append(t.ms)
        res["scale_1m_step_ms"] = times
        res["scale_1m_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    line = json.dumps(res)
    print(line)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"stream_step_{args.tag}.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
