"""One rank of a sharded run: the counterpart of
``benchmarks/multihost_worker.py``.

    torchrun --standalone --nproc_per_node 2 \\
        -m raytracingincuda_torch.parallel.worker --outdir OUT [--device cpu]

Each rank joins the process group ``torchrun`` describes
(``parallel/mesh.py``), then runs a list of jobs on its slice of the
pixels. By default: ``render`` (``make_renderer`` over the world; each
rank writes its pixel slice as a part file, rank 0 stitches the parts and
writes the image directly, and checks that the two PPMs have the same
bytes), ``grads`` (``grad.render_grads`` through the oracle) and
``fused`` (one ``make_mse_train`` step, kernel 2 on a card), at the shape
the flags give. ``--jobs FILE`` runs a JSON list of jobs instead, each a
dict with ``job`` and keys that override the flags' shape (``scene_id``,
``width``, ``height``, ``samples``, ``bounces``, ``rr_start``, ``impl``,
``dtype``, ``n_spheres`` for a random scene (seed 3, ``half_extent``),
``axes`` for the mesh's axis names, ``tag`` for the saved file). The
jobs: ``render`` (``make_renderer``, with ``max_samples`` and
``adaptive_tol`` for ``impl`` adaptive; ``stitch`` false skips the part
files and PPMs), ``kernel`` (``render_kernel``, with ``mode``),
``stream`` (``render_stream`` over blocks of ``stream_block`` rows),
``adaptive`` (``render_adaptive``: the image and the spp map, on the
stream kernel with ``stream_block``; ``rounds``), ``grads``
(``render_grads``), ``fused`` (``make_mse_train``; ``order``
'difficulty' for the difficulty order), ``train`` (one
``make_train_step`` step) and ``stream_train`` (one ``make_stream_train``
step, ``fused``). Targets are ``torch.rand`` from seed 0.

Every job saves its outputs as ``{tag}_r{rank}.npz`` under ``--outdir``;
the gradient jobs (``grads``, ``fused``, ``train``, ``stream_train``) run
twice and report whether the two runs gave the same bits, and the
``all_reduce`` calls a step made, their sizes and the seconds spent in
them (the port's ``all_reduce.*`` counters and ``rt.all_reduce`` spans,
``utils/trace.py``, read under ``recording()``) and each run's seconds.
Each job reports the kernel launches this rank made, its wall seconds
and, on a card, its peak device memory. Every rank writes
``status_r{rank}.json``; rank 0 prints the JSON line of all of them.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def _launches() -> dict:
    """The kernel launches counted so far, by kernel."""
    from ..utils import trace

    return {k[len("launch."):]: n for k, n in trace.counts().items()
            if k.startswith("launch.")}


def _all_reduces(step) -> tuple:
    """Run ``step()`` with the port's spans on: (its result, the
    ``all_reduce`` calls it made, each call's elements, the seconds in
    the ``rt.all_reduce`` spans)."""
    from ..utils import trace

    first = len(trace.records())
    calls = trace.counts().get("all_reduce.calls", 0)
    with trace.recording():
        out = step()
    spans = [r for r in trace.records()[first:] if r.name == "rt.all_reduce"]
    return (out, trace.counts().get("all_reduce.calls", 0) - calls,
            [r.counts["all_reduce.numel"] for r in spans],
            sum(r.end_ns - r.start_ns for r in spans) / 1e9)


def _scene(job, device):
    from ..models.scene import build_random_scene, build_scene

    if job.get("n_spheres"):
        return build_random_scene(job["n_spheres"], seed=3,
                                  half_extent=job.get("half_extent", 50.0),
                                  device=device)
    return build_scene(job["scene_id"], device=device)


def _target(job, device):
    import torch

    gen = torch.Generator().manual_seed(0)
    return torch.rand((job["height"], job["width"], 3),
                      generator=gen).to(device)


def _numpy(tree) -> dict:
    """Flat {name: ndarray} of a result (tensors, named tuples, lists)."""
    import numpy as np
    import torch

    out = {}

    def walk(name, x):
        if isinstance(x, torch.Tensor):
            out[name] = x.detach().cpu().numpy()
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                walk(f"{name}.{f}", getattr(x, f))
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(f"{name}.{i}", v)
        elif isinstance(x, (int, float)):
            out[name] = np.asarray(x)

    walk("out", tree)
    return out


def _same(a: dict, b: dict) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def _render(job, mesh, device, outdir):
    """make_renderer over the world; part files and the stitch."""
    import numpy as np
    import torch

    from ..config import RenderConfig
    from ..models.camera import CameraConfig
    from ..parallel import mesh as meshlib
    from ..render_api import make_renderer
    from ..utils.ppm import write_ppm
    from ..utils.stitch import save_image_part, stitch_parts

    cfg = RenderConfig(
        scene_id=job["scene_id"], width=job["width"], height=job["height"],
        samples=job["samples"], bounces=job["bounces"], impl=job["impl"],
        dtype=job.get("dtype", "float32"), rr_start=job["rr_start"],
        max_samples=job.get("max_samples"),
        adaptive_tol=job.get("adaptive_tol", 0.05))
    img = make_renderer(cfg, device)(_scene(job, device),
                                     CameraConfig.reference_default())
    if not job.get("stitch", True):
        return img, {}
    n = job["width"] * job["height"]
    lanes = meshlib.local_slice(meshlib.padded_lanes(n, mesh), mesh)
    lo, hi = min(lanes.start, n), min(lanes.stop, n)
    flat = img.detach().cpu().numpy().reshape(n, 3)
    tag = job["tag"]
    save_image_part(os.path.join(outdir, f"{tag}.part{mesh.rank}.npz"),
                    flat[lo:hi], lo, (job["height"], job["width"]))
    if meshlib.sharded(mesh):
        torch.distributed.barrier()
    rec = {"part_pixels": [lo, hi]}
    if mesh.rank == 0:
        parts = [os.path.join(outdir, f"{tag}.part{r}.npz")
                 for r in range(mesh.world)]
        stitched = os.path.join(outdir, f"{tag}.stitched.ppm")
        direct = os.path.join(outdir, f"{tag}.ppm")
        write_ppm(stitched, stitch_parts(parts).astype(np.float64))
        write_ppm(direct, flat.reshape(job["height"], job["width"], 3))
        with open(stitched, "rb") as a, open(direct, "rb") as b:
            rec["ppm_identical"] = a.read() == b.read()
    return img, rec


def _kernel(job, mesh, device, outdir):
    """render_kernel on the job's mesh (``mode`` regen, compact, simple)."""
    from ..models.camera import CameraConfig
    from ..ops import render_kernel as rk

    return rk.render_kernel(
        _scene(job, device), CameraConfig.reference_default(), job["width"],
        job["height"], job["samples"], job["bounces"],
        rr_start=job["rr_start"], mode=job.get("mode", "regen"),
        mesh=mesh), {}


def _stream(job, mesh, device, outdir):
    """render_stream over blocks of ``stream_block`` rows."""
    from ..models.camera import CameraConfig
    from ..ops import stream_kernel as sk

    stream = sk.prepare_stream_scene(_scene(job, device),
                                     block=job.get("stream_block", 256))
    return sk.render_stream(
        stream, CameraConfig.reference_default(), job["width"],
        job["height"], job["samples"], job["bounces"],
        rr_start=job["rr_start"], mesh=mesh), {}


def _adaptive(job, mesh, device, outdir):
    from ..models.camera import CameraConfig
    from ..ops import stream_kernel as sk
    from ..ops.adaptive import render_adaptive

    scene = _scene(job, device)
    stream = (sk.prepare_stream_scene(scene, block=job["stream_block"])
              if job.get("stream_block") else None)
    res = render_adaptive(
        scene, CameraConfig.reference_default(), job["width"],
        job["height"], job["bounces"], base_spp=job["samples"],
        max_spp=job.get("max_samples") or 4 * job["samples"],
        tol=job.get("adaptive_tol", 0.05), rr_start=job["rr_start"],
        rounds=job.get("rounds", 1), stream=stream, mesh=mesh)
    return (res.image, res.spp_map), {"spp_mean": float(res.spp_map.float()
                                                        .mean())}


def _order(job, scene, cam):
    from ..ops import render_kernel as rk

    if job.get("order") != "difficulty":
        return None
    seg = rk.measure_difficulty(scene, cam, job["width"], job["height"], 8, 6)
    return rk.difficulty_order(seg, 8, 6)


def _gradient_job(job, mesh, device):
    """``step()`` for a gradient job, returning the outputs to save."""
    import torch

    from ..models.camera import CameraConfig
    from ..ops import grad as gradlib
    from ..ops import stream_kernel as sk
    from ..ops import train_kernel as tk

    scene, cam = _scene(job, device), CameraConfig.reference_default()
    target = _target(job, device)
    shape = (job["width"], job["height"], job["samples"], job["bounces"])
    kind = job["job"]
    if kind == "grads":
        dtype = (torch.float64 if job.get("dtype") == "float64"
                 else torch.float32)
        return lambda: gradlib.render_grads(
            scene, cam, target, *shape, impl=job["impl"], dtype=dtype,
            rr_start=job["rr_start"], mesh=mesh)
    if kind == "fused":
        step = tk.make_mse_train(scene.mat_type, scene.active, *shape,
                                 gamma=True, rr_start=job["rr_start"],
                                 pixel_order=_order(job, scene, cam),
                                 mesh=mesh)
        return lambda: step(scene.params, cam, target)
    if kind == "train":
        init_fn, step_fn = gradlib.make_train_step(
            *shape, impl=job["impl"], rr_start=job["rr_start"], mesh=mesh)
        state = init_fn(scene.params)
        return lambda: step_fn(state, cam, scene.mat_type, scene.active,
                               target)
    if kind == "stream_train":
        stream = sk.prepare_stream_scene(scene,
                                         block=job.get("stream_block", 256))
        init_fn, step_fn = gradlib.make_stream_train(
            stream, *shape, fused=job.get("fused", True), mesh=mesh)
        state = init_fn(scene.params)
        return lambda: step_fn(state, cam, scene.mat_type, scene.active,
                               target)
    raise ValueError(f"unknown job {kind!r}")


_FORWARD = {"render": _render, "kernel": _kernel, "stream": _stream,
            "adaptive": _adaptive}


def run_job(job: dict, defaults: dict, device, outdir: str,
            backend=None) -> dict:
    """Run one job on this rank; save its outputs; return its record."""
    import numpy as np
    import torch

    from ..parallel import mesh as meshlib

    job = {**defaults, **job}
    job.setdefault("tag", job["job"])
    mesh = meshlib.make_mesh(0, axis_names=job.get("axes", ("dp",)),
                             backend=backend, device=device)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    t0 = time.perf_counter()
    rec = {"job": job["job"], "tag": job["tag"]}
    if job["job"] in _FORWARD:
        out, extra = _FORWARD[job["job"]](job, mesh, dev, outdir)
        rec.update(extra)
        arrays = _numpy(out)
    else:
        step = _gradient_job(job, mesh, dev)
        runs = []
        for _ in range(2):
            t1 = time.perf_counter()
            out, calls, numel, secs = _all_reduces(step)
            runs.append(_numpy(out))
            rec.setdefault("run_secs", []).append(time.perf_counter() - t1)
            rec.setdefault("all_reduce_secs", []).append(secs)
            rec.setdefault("all_reduces_a_step", calls)
            rec.setdefault("all_reduce_numel", numel)
        rec["runs_bit_identical"] = _same(*runs)
        arrays = runs[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        rec["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    rec["secs"] = time.perf_counter() - t0
    after = _launches()
    rec["launches"] = {k: n - before.get(k, 0) for k, n in after.items()
                       if n != before.get(k, 0)}
    rec["mesh_shape"] = list(mesh.shape)
    np.savez(os.path.join(outdir, f"{job['tag']}_r{mesh.rank}.npz"), **arrays)
    return rec


def torchrun(args: list, nproc: int = 2, timeout: float = 600.0, env=None,
             cwd=None):
    """Run ``python -m torch.distributed.run --standalone --nproc_per_node
    nproc`` with ``args`` (for example ``["-m",
    "raytracingincuda_torch.parallel.worker", ...]``) in a session of its
    own; returns the ``subprocess.CompletedProcess`` (text). On timeout the
    whole session (the launcher and its ranks) is killed and
    ``subprocess.TimeoutExpired`` raised, so a hung rendezvous fails in
    ``timeout`` seconds."""
    import signal
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=cwd, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytrace-torch-worker")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda",
                   help="cuda (default: this rank's card; raises without "
                        "CUDA) or cpu")
    ap.add_argument("--backend", default=None,
                   help="gloo, nccl or cpu:gloo,cuda:nccl (default: nccl "
                        "only where every rank has a card of its own)")
    ap.add_argument("--jobs", default=None, help="a JSON file of jobs")
    ap.add_argument("--scene_id", type=int, default=2)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--rr_start", type=int, default=None)
    ap.add_argument("--impl", default="kernel")
    args = ap.parse_args(argv)

    import torch

    from ..parallel import mesh as meshlib

    meshlib.maybe_initialize_distributed(args.backend)
    rank = meshlib.make_mesh(0, device=args.device).rank
    defaults = dict(scene_id=args.scene_id, width=args.width,
                    height=args.height, samples=args.samples,
                    bounces=args.bounces, rr_start=args.rr_start,
                    impl=args.impl)
    if args.jobs:
        with open(args.jobs) as f:
            jobs = json.load(f)
    else:
        jobs = [{"job": "render"}, {"job": "grads", "impl": "oracle"},
                {"job": "fused"}]
    os.makedirs(args.outdir, exist_ok=True)
    status = {"rank": rank, "world": meshlib.world_size(),
              "backend": (torch.distributed.get_backend()
                          if torch.distributed.is_initialized() else None),
              "jobs": [run_job(j, defaults, args.device, args.outdir,
                               args.backend) for j in jobs]}
    with open(os.path.join(args.outdir, f"status_r{rank}.json"), "w") as f:
        json.dump(status, f)
    if meshlib.world_size() > 1:
        torch.distributed.barrier()
    if rank == 0:
        statuses = []
        for r in range(meshlib.world_size()):
            with open(os.path.join(args.outdir, f"status_r{r}.json")) as f:
                statuses.append(json.load(f))
        print(json.dumps({"ranks": statuses}), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
