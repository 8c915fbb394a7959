#!/usr/bin/env python3
"""Count and time the stream walk (kernels 4 and 5) at the benchmark's
stream shapes on one CUDA card, for comparing trees of the port on the
same card in one call.

    PYTHONPATH=<tree> python3 probes/stream_walk.py --tag NAME [--reps N]
        [--no-1m]

The package is imported from ``PYTHONPATH``: unpack the parent with ``git
archive <sha> | tar -x -C _local/parent`` and run parent, change, change,
parent. Shapes (the stream cells of ``BENCHMARK.json``):

  * ``render``: kernel 4 on 100k random spheres (seed 3, blocks of 256,
    front to back from the camera) at 640x384, 10 spp, 10 bounces, parity;
  * ``train_100k``: kernel 5's fused mode on the stream the 100k train step
    walks (``build_stream_arrays`` in ``front_to_back_border``'s order) at
    640x384, 4 spp, 10 bounces;
  * ``train_1m``: the same on 1M random spheres (seed 7, blocks of 1024) at
    640x384, 1 spp, 6 bounces.

Each shape reports the kernel's mean ms over ``--reps`` launches (CUDA
events; kernel 5's fused call includes its record sort and sum) and the
count mode's work, summed over the warps: ``segments`` (every lane's
traced segments), ``warp_iterations`` (kernel 4: each warp's largest lane
count of segments, the walk calls the warp makes), ``opened`` (blocks
opened, each lane's), ``warp_blocks`` (the union a warp walks),
``bound_tests`` (bounds rows a warp tests: ``warp_iterations`` x nb) and
``rows_tested`` (the slot rows a warp tests: the count mode's fourth row
where the tree has one, else every row of ``warp_blocks``), with
``rows_tested_share`` = rows_tested / (warp_blocks x block); and the
SHA-256 of what the kernels return (kernel 4's image; kernel 5's records,
image, loss and gradients), so that two trees' outputs compare bit for bit
across processes. ``render_request`` is one request of the stream render
cell (``make_renderer(impl='stream')``, its stream prepared first) with
the port's spans on: the counters that rose inside its ``rt.render`` span.
Prints one JSON line and writes it to ``chiprun_out/stream_walk_<tag>.json``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
from pathlib import Path

import torch


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed(fn, reps):
    """Mean ms of ``reps`` calls after a warm-up, one CUDA-event bracket."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def work(st, *, segments=None, warp_iterations=None, opened, warp_blocks,
         rows_tested=None):
    nb, block = st.bounds.shape[0], st.block
    out = {"nb": nb, "block": block, "opened": opened,
           "warp_blocks": warp_blocks}
    if segments is not None:
        out.update(segments=segments, warp_iterations=warp_iterations,
                   bound_tests=warp_iterations * nb)
    rows = warp_blocks * block if rows_tested is None else rows_tested
    out.update(rows_tested=rows,
               rows_tested_share=rows / (warp_blocks * block),
               counted_rows=rows_tested is not None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-1m", dest="one_m", action="store_false")
    args = ap.parse_args()

    import raytracingincuda_torch
    from raytracingincuda_torch.config import RenderConfig
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
    from raytracingincuda_torch.render_api import make_renderer
    from raytracingincuda_torch.utils import trace

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    res = {"tag": args.tag, "card": card,
           "package": str(Path(raytracingincuda_torch.__file__).parent)}
    cam = CameraConfig.reference_default()
    w, h = 640, 384
    row = rk.pack_camera(initialize(cam, w, h)).to(dev)

    # kernel 4 at the stream render cell's shape
    s100k = build_random_scene(100_000, seed=3, device=dev)
    stream = sk.prepare_stream_scene(s100k)
    front = sk.reorder_front_to_back(stream, initialize(cam, w, h).center)
    ids, ii, jj, bud = kio.lane_setup(w, h, None, 10, 0, None, dev)
    kw = dict(block=front.block, samples=10, max_depth=10, rr_start=None,
              finalize_scale=0.1)
    args4 = (ids, ii, jj, bud, front.scene_mat, front.bounds, row)
    c = sk.stream_kernel(*args4, emit_stats=True, **kw).double()
    seg = c[0].view(-1, 32)
    res["render"] = work(
        front, segments=int(seg.sum()),
        warp_iterations=int(seg.amax(1).sum()), opened=int(c[1].sum()),
        warp_blocks=int(c[2].sum()),
        rows_tested=int(c[3].sum()) if c.shape[0] > 3 else None)
    res["render"]["kernel4_ms"] = timed(
        lambda: sk.stream_kernel(*args4, **kw), args.reps)
    res["render"]["sha_image"] = digest(sk.stream_kernel(*args4, **kw))
    del c, seg
    renderer = make_renderer(RenderConfig(
        scene_id=0, width=w, height=h, samples=10, bounces=10, impl="stream"),
        dev)
    renderer.prepare(s100k)
    renderer(s100k, cam)
    torch.cuda.synchronize()
    trace.reset()
    with trace.recording():
        renderer(s100k, cam)
        torch.cuda.synchronize()
    res["render_request"] = next(r.counts for r in trace.records()
                                 if r.name == "rt.render")
    del renderer

    def train_shape(scene, prepared, samples, depth):
        border = gradlib.front_to_back_border(prepared, cam, w, h)
        st = StreamScene(*sk.build_stream_arrays(
            Scene(scene.params, scene.mat_type, scene.active), prepared.perm,
            prepared.block, prepared.scene_mat.shape[0], border=border),
            prepared.block, prepared.perm)
        ids, ii, jj, _ = kio.lane_setup(w, h, None, samples, 0, None, dev)
        counts = stk.walk_counts(ids, ii, jj, st.scene_mat, st.bounds, row,
                                 block=st.block, samples=samples,
                                 max_depth=depth)
        out = work(st, opened=int(counts[0].long().sum()),
                   warp_blocks=int(counts[1].long().sum()),
                   rows_tested=(int(counts[2].long().sum())
                                if len(counts) > 2 else None))
        tgt = kio.lane_rows(torch.rand((h, w, 3), generator=torch.Generator()
                                       .manual_seed(5)).to(dev), ids, w * h)
        a5 = (ids, ii, jj, tgt, st.scene_mat, st.bounds, row)
        kw = dict(block=st.block, samples=samples, max_depth=depth)
        out["kernel5_fused_ms"] = timed(lambda: stk.fused_stream_kernel(
            *a5, num_pixels=w * h, loss="mse", gamma=False, **kw), args.reps)
        out["sha_step"] = digest(*stk.fused_stream_kernel(
            *a5, num_pixels=w * h, loss="mse", gamma=False, **kw))
        recs = stk.train_records(*a5, seed=DEFAULT_SEED, rr_start=None,
                                 sample_offset=0, fused=True,
                                 num_pixels=w * h, **kw)
        out["sha_records"] = digest(*recs)
        del recs
        return out

    res["train_100k"] = train_shape(s100k, stream, 4, 10)
    del s100k, stream, front
    if args.one_m:
        s1m = build_random_scene(1_000_000, seed=7, device=dev)
        res["train_1m"] = train_shape(s1m, sk.prepare_stream_scene(s1m), 1, 6)
    line = json.dumps(res)
    print(line)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"stream_walk_{args.tag}.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
