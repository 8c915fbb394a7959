#!/usr/bin/env python3
"""Time the forward renders and the steps around them on one CUDA card,
with the counts behind them, for comparing trees of the port on the same
card in one call.

    PYTHONPATH=<tree> python3 probes/render_step.py --tag NAME [--reps N]
        [--counts] [--no-times] [--parts render train stream f64 compact]

The package is imported from ``PYTHONPATH``, so one call can time several
checkouts: unpack the parent with ``git archive <sha> | tar -x -C
_local/parent`` and run parent, change, change, parent. Each time is a
CUDA-event bracket; renders and steps take a warm-up, then ``--reps``.

  * the headline renders (``make_renderer``, scene 1, 1280x768, 100 spp, 25
    bounces, parity and rr2), and the same renders through
    ``render_kernel`` with the difficulty order (``_sorted_ms``) and
    without it (``_unsorted_ms``);
  * kernel 1's row: ``regen_kernel`` at 1280x768x2spp/25b parity;
  * the headline fused train step (``make_mse_train``, rr2, gamma, MSE,
    the difficulty order, as ``bench.py`` configures it; and without the
    order), kernel 2's row (1280x768x2spp/25b rr2) and kernel 3's row
    (320x192x4spp/8b rr2);
  * the 100k stream render (``make_renderer(impl='stream')``, 100k random
    spheres, seed 3, 640x384, 10 spp, 10 bounces);
  * on the 100k stream step's stream (blocks of 256, front to back) at
    640x384x1spp/3b: kernel 4's row (``stream_kernel``) and kernel 5's
    (``fused_stream_kernel``);
  * the 100k stream train step (``make_stream_train``, fused, 4 spp, 10
    bounces, MSE);
  * the f64 headline (``make_renderer(dtype='float64')``, scene 1,
    1280x768, 100 spp, 25 bounces, parity), and ``--pairs`` pairs of
    ``render_f64`` with the f32 difficulty order and without it; kernel 6's
    row: ``f64_kernel`` at 1280x768x2spp/25b parity;
  * the compact headline (``render_kernel(mode='compact')``, 100 spp, 25
    bounces, parity) in turns with kernel 1's (``mode='regen'``, no order);
    kernel 7's row: ``compact_kernel`` at 1280x768x2spp/25b.

With ``--counts`` (trees that have ``regen_counts``), beside the times:
kernel 1's hit-test issues per warp against the lanes' mean segments at
row 1's shape and at the headline (both estimators, with and without the
order), beside the per-sample count of the nested loop that kernel 1 ran
before it regenerated; and kernel 4's work
(segments, opened blocks, the warps' union) at row 4's shape and the 100k
render's, beside kernel 5's union (``walk_counts``). ``--no-times`` takes
the counts alone; ``--parts`` times only some of the groups above (the
headline renders and kernel 1; the fused step and kernels 2 and 3; the
stream render, kernels 4 and 5 and the stream step; the f64 headline and
kernel 6; the compact headline and kernel 7). Prints one JSON line and
writes it to
``chiprun_out/render_step_<tag>.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

PARTS = ("render", "train", "stream", "f64", "compact")


def timed(fn, reps):
    """Mean ms of ``reps`` calls after a warm-up, one CUDA-event bracket."""
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


def each(fn, reps, timer, dev):
    """A warm-up, then ``reps`` calls, each in its own bracket."""
    fn()
    times = []
    for _ in range(reps):
        with timer(dev) as t:
            fn()
        times.append(t.ms)
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--counts", action="store_true")
    ap.add_argument("--no-times", dest="times", action="store_false")
    ap.add_argument("--parts", nargs="*", choices=PARTS, default=PARTS)
    args = ap.parse_args()

    import raytracingincuda_torch
    from raytracingincuda_torch.config import RenderConfig
    from raytracingincuda_torch.models.camera import CameraConfig, initialize
    from raytracingincuda_torch.models.scene import (Scene, build_random_scene,
                                                      build_scene)
    from raytracingincuda_torch.ops import compact_kernel as ck
    from raytracingincuda_torch.ops import f64_kernel as fk
    from raytracingincuda_torch.ops import grad as gradlib
    from raytracingincuda_torch.ops import render_kernel as rk
    from raytracingincuda_torch.ops import stream_kernel as sk
    from raytracingincuda_torch.ops import stream_train_kernel as stk
    from raytracingincuda_torch.ops import train_kernel as tk
    from raytracingincuda_torch.ops.stream_kernel import StreamScene
    from raytracingincuda_torch.render_api import make_renderer
    from raytracingincuda_torch.utils.timing import RenderTimer

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    res = {"tag": args.tag, "card": card,
           "package": str(Path(raytracingincuda_torch.__file__).parent)}
    cam = CameraConfig.reference_default()
    w, h, spp, bounces = 1280, 768, 100, 25
    sw, sh = 640, 384
    reps = args.reps
    go = {part: args.times and part in args.parts for part in PARTS}
    counts = args.counts and hasattr(rk, "regen_counts")
    scene = build_scene(1, device=dev)
    order = rk.difficulty_order(rk.measure_difficulty(scene, cam, w, h, 8, 6),
                                8, 6)

    def warp_counts(inputs, samples, depth, rr):
        """Hit-test issues summed over warps, the warps' lanes' mean
        segments summed over warps, and the nested loop's per-sample count
        of the same segments."""
        seg, issues, *_ = rk.regen_counts(*inputs, samples=samples,
                                          max_depth=depth, rr_start=rr)
        per = rk.sample_segments(*inputs, samples=samples, max_depth=depth,
                                 rr_start=rr)
        mean = float(seg.double().view(-1, 32).mean(1).sum())
        nested = float(rk.warp_iterations(per, "nested").sum())
        out = {"warp_issues": int(issues.long().sum()),
               "lane_mean_segments": mean,
               "ratio": float(issues.double().sum()) / mean,
               "nested_ratio": nested / mean}
        for loop in ("compact", "pool"):
            if loop in rk.LOOPS:
                out[f"{loop}_ratio"] = float(
                    rk.warp_iterations(per, loop).sum()) / mean
        return out

    # the headline renders, with and without the order
    for rr in (None, 2):
        name = "parity" if rr is None else f"rr{rr}"
        if go["render"]:
            renderer = make_renderer(RenderConfig(
                scene_id=1, width=w, height=h, samples=spp, bounces=bounces,
                rr_start=rr), dev)
            res[f"headline_{name}_ms"] = each(lambda: renderer(scene, cam),
                                              reps, RenderTimer, dev)
            for sort, po in (("sorted", order), ("unsorted", None)):
                res[f"headline_{name}_{sort}_ms"] = each(
                    lambda: rk.render_kernel(scene, cam, w, h, spp, bounces,
                                             rr_start=rr, pixel_order=po),
                    reps, RenderTimer, dev)
        if counts:
            for sort, po in (("sorted", order), ("unsorted", None)):
                inputs = rk.regen_inputs(scene, cam, w, h, spp, pixel_order=po)
                res[f"counts_headline_{name}_{sort}"] = warp_counts(
                    inputs, spp, bounces, rr)
    # kernel 1's row
    inputs = rk.regen_inputs(scene, cam, w, h, 2)
    if counts:
        res["counts_row1"] = warp_counts(inputs, 2, 25, None)
    if go["render"]:
        _, res["kernel1_ms"] = timed(lambda: rk.regen_kernel(
            *inputs, samples=2, max_depth=25, finalize_scale=0.5), reps)
    if go["train"]:
        # the headline fused step, kernels 2 and 3
        target = torch.rand((h, w, 3), generator=torch.Generator()
                            .manual_seed(0)).to(dev)
        for key, po in (("fused_step_ms", order),
                        ("fused_step_unsorted_ms", None)):
            step = tk.make_mse_train(scene.mat_type, scene.active, w, h, spp,
                                     bounces, gamma=True, pixel_order=po,
                                     rr_start=2)
            res[key] = each(lambda: step(scene.params, cam, target), reps,
                            RenderTimer, dev)
            del step
        del target
        ids, ii, jj, _, sm, row = rk.regen_inputs(scene, cam, w, h, 2)
        tgt = torch.rand((3, ids.shape[0]), generator=torch.Generator()
                         .manual_seed(4)).to(dev)
        _, res["kernel2_ms"] = timed(lambda: tk.fused_train_kernel(
            ids, ii, jj, tgt, sm, row, samples=2, max_depth=25, rr_start=2,
            num_pixels=w * h, gamma=True, loss="mse"), reps)
        ids, ii, jj, _, sm, row = rk.regen_inputs(scene, cam, 320, 192, 4)
        g = (torch.randn((3, ids.shape[0]), generator=torch.Generator()
                         .manual_seed(3)) * 1e-4).to(dev)
        _, res["kernel3_ms"] = timed(lambda: tk.grad_kernel(
            ids, ii, jj, g, sm, row, samples=4, max_depth=8, rr_start=2), reps)
    # the 100k stream render, and the step's stream
    if go["stream"] or counts:
        s100k = build_random_scene(100_000, seed=3, device=dev)
        stream = sk.prepare_stream_scene(s100k)
        border = gradlib.front_to_back_border(stream, cam, sw, sh)
        st0 = StreamScene(*sk.build_stream_arrays(
            Scene(s100k.params, s100k.mat_type, s100k.active), stream.perm,
            stream.block, stream.scene_mat.shape[0], border=border),
            stream.block, stream.perm)
        row = rk.pack_camera(initialize(cam, sw, sh)).to(dev)
    if go["stream"]:
        renderer = make_renderer(RenderConfig(
            scene_id=0, width=sw, height=sh, samples=10, bounces=10,
            impl="stream"), dev)
        renderer.prepare(s100k)
        res["stream_render_ms"] = each(lambda: renderer(s100k, cam), reps,
                                       RenderTimer, dev)
        # kernels 4 and 5 at 640x384x1spp/3b
        ids, ii, jj, bud = rk._lane_setup(sw, sh, None, 1, 0, None, dev)
        kw = dict(block=st0.block, samples=1, max_depth=3, rr_start=None)
        _, res["kernel4_ms"] = timed(lambda: sk.stream_kernel(
            ids, ii, jj, bud, st0.scene_mat, st0.bounds, row, **kw), reps)
        tgt = torch.rand((3, ids.shape[0]), generator=torch.Generator()
                         .manual_seed(6)).to(dev)
        _, res["kernel5_ms"] = timed(lambda: stk.fused_stream_kernel(
            ids, ii, jj, tgt, st0.scene_mat, st0.bounds, row,
            num_pixels=sw * sh, loss="mse", gamma=False, **kw), reps)
        # the 100k stream train step
        target = torch.rand((sh, sw, 3), generator=torch.Generator()
                            .manual_seed(5)).to(dev)
        init_fn, step_fn = gradlib.make_stream_train(stream, sw, sh, 4, 10)
        state0 = init_fn(s100k.params)
        res["stream_step_ms"] = each(
            lambda: step_fn(state0, cam, s100k.mat_type, s100k.active,
                            target), reps, RenderTimer, dev)
    if counts:
        def walk_work(st, samples, depth):
            ids, ii, jj, bud = rk._lane_setup(sw, sh, None, samples, 0, None,
                                              dev)
            c = sk.stream_kernel(ids, ii, jj, bud, st.scene_mat, st.bounds,
                                 row, block=st.block, samples=samples,
                                 max_depth=depth, emit_stats=True)
            c = c.double().sum(1)
            opened, fetched = stk.walk_counts(
                ids, ii, jj, st.scene_mat, st.bounds, row, block=st.block,
                samples=samples, max_depth=depth)
            return {"segments": float(c[0]), "opened": float(c[1]),
                    "kernel4_fetched": float(c[2]),
                    "kernel4_lane_tests_over_opened":
                        32 * float(c[2]) / float(c[1]),
                    "kernel5_opened": int(opened.long().sum()),
                    "kernel5_fetched": int(fetched.long().sum()),
                    "kernel5_lane_tests_over_opened": 32 * float(
                        fetched.double().sum()) / float(opened.double().sum())}
        res["counts_row4"] = walk_work(st0, 1, 3)
        res["counts_stream_render"] = walk_work(
            sk.reorder_front_to_back(stream, initialize(cam, sw, sh).center),
            10, 10)
    if go["f64"]:
        # the f64 headline through the renderer, then with and without the
        # f32 difficulty order in turns
        renderer = make_renderer(RenderConfig(
            scene_id=1, width=w, height=h, samples=spp, bounces=bounces,
            dtype="float64"), dev)
        res["f64_headline_ms"] = each(lambda: renderer(scene, cam), reps,
                                      RenderTimer, dev)
        pairs = []
        for _ in range(args.pairs):
            pair = []
            for po in (order, None):
                with RenderTimer(dev) as t:
                    fk.render_f64(scene, cam, w, h, spp, bounces,
                                  pixel_order=po)
                pair.append(t.ms)
            pairs.append(pair)
        res["f64_ordered_raster_pairs_ms"] = pairs
        inputs = fk.f64_inputs(scene, cam, w, h)
        _, res["kernel6_ms"] = timed(lambda: fk.f64_kernel(
            *inputs, samples=2, max_depth=25), reps)
    if go["compact"]:
        # the compact headline in turns with kernel 1's, then kernel 7's row
        turns = []
        for _ in range(reps + 1):
            turn = []
            for mode in ("compact", "regen"):
                with RenderTimer(dev) as t:
                    rk.render_kernel(scene, cam, w, h, spp, bounces, mode=mode)
                turn.append(t.ms)
            turns.append(turn)
        res["compact_regen_turns_ms"] = turns[1:]
        ids, ii, jj, _, sm, row = rk.regen_inputs(scene, cam, w, h, 2)
        _, res["kernel7_ms"] = timed(lambda: ck.compact_kernel(
            ids, ii, jj, sm, row, samples=2, max_depth=25,
            finalize_scale=0.5), reps)
    line = json.dumps(res)
    print(line)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"render_step_{args.tag}.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
