"""One run of one cell: set-up, the measured window, the check, the line.

Everything that belongs to a cell is found by name: the cell's entry in
``BENCHMARK.json`` (its configuration, traffic and chips, and which
metrics it reports), its file ``workloads/<cell>.json`` (the entry kind,
the traffic's parameters, the check's sizes and limits), the
configuration ``configs/<config>.json``, the entry ``entries/<entry>.py``
and a metric's reader ``metrics/<metric>.py`` (or ``metrics/<stem>.py``,
which serves every metric whose name has that stem before a dot). A
cell, a configuration or a metric is added by adding files and entries,
never by an edit here.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import traceback
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

FENCED = ("jax", "jaxlib", "flax", "raytracingincuda_tpu")
THREADS = 1


def load_module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{tag}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def load_cell(root: Path, name: str) -> SimpleNamespace:
    """The cell ``name`` as the files under ``root`` define it."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    spec = [w for w in bench["workloads"] if w["name"] == name]
    if len(spec) != 1:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    spec = spec[0]
    base = root / "portbench"
    cell = json.loads((base / "workloads" / f"{name}.json").read_text())
    if (cell["config"], cell["traffic"]) != (spec["config"], spec["traffic"]):
        raise SystemExit(f"workloads/{name}.json names {cell['config']} / "
                         f"{cell['traffic']}, BENCHMARK.json "
                         f"{spec['config']} / {spec['traffic']}")
    config = json.loads((base / "configs" / f"{spec['config']}.json"
                         ).read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return SimpleNamespace(name=name, spec=spec, cell=cell, config=config,
                           end_to_end=e2e, per_layer=layer, base=base)


def metric_file(base: Path, name: str) -> Path:
    """``metrics/<name>.py``, or the reader of every metric whose name has
    the same stem (before the first dot), ``metrics/<stem>.py``."""
    own = base / "metrics" / f"{name}.py"
    return own if own.exists() else base / "metrics" / (
        name.split(".")[0] + ".py")


def fenced_modules() -> list:
    """Modules loaded whose top-level name is the JAX stack's or the JAX
    package's (compared whole: the port's name begins with the latter's)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FENCED))


def device_record(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips,
           "memory_peak_bytes": int(max(
               torch.cuda.max_memory_allocated(d) for d in range(chips)))}
    return rec


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def set_up(cell, seed: int, device, phase=lambda name: None):
    """(the context an entry reads, the cell's entry, set up): the entry's
    ``make`` builds the scene, the cell's preparation and the warm-up."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ctx = SimpleNamespace(cell=cell.cell, config=cell.config, seed=int(seed),
                          device=device, sync=sync, phase=phase)
    entry = load_module(cell.base / "entries" / f"{cell.cell['entry']}.py",
                        "entry").make(ctx)
    sync()
    return ctx, entry


def run(name: str, seed: int, seconds: float, trace: bool, *, root: Path,
        device, t0: float, log=sys.stderr) -> dict:
    """Run cell ``name`` once; returns the result line's object (the
    ``checks`` key last)."""
    import torch

    from . import port
    from .trace import REQUEST_MARK, WINDOW_MARK, Tracer, library_kernels, top

    torch.set_num_threads(THREADS)
    cell = load_cell(root, name)
    phases = [("start", t0), ("imports", time.perf_counter())]
    ctx, entry = set_up(cell, seed, device, lambda n: phases.append(
        (n, time.perf_counter())))
    ctx.phase("warm-up")
    setup_s = time.perf_counter() - t0
    print("setup: " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b)
                                in zip(phases, phases[1:])), file=log)

    latencies, attempted, failed = [], 0, 0
    tracer = Tracer() if trace else nullcontext()
    mark = ((lambda n: torch.profiler.record_function(n)) if trace
            else (lambda n: nullcontext()))
    gc.collect()
    gc.freeze()      # set-up's objects out of the window's collections
    with tracer:
        if trace:    # the profiler's start-up falls on a request outside
            entry.request(-2)
        with mark(WINDOW_MARK):
            w0 = time.perf_counter()
            j, end = 0, w0
            while end - w0 < seconds:
                attempted += 1
                with mark(REQUEST_MARK):
                    a = time.perf_counter()
                    try:
                        out = entry.request(j)
                    except Exception:          # counted, reported, not fatal
                        failed += 1
                        out = None
                        traceback.print_exc(file=log)
                    end = time.perf_counter()
                if out is not None:
                    latencies.append(end - a)
                    entry.keep(j, out)
                del out
                j += 1
            window_s = end - w0
    gc.unfreeze()
    quarters = [sorted(latencies[k * len(latencies) // 4:
                                 (k + 1) * len(latencies) // 4])
                for k in range(4)]
    print(f"window: {attempted} requests in {window_s:.3f} s; median ms by "
          "quarter of the window: " + ", ".join(
              f"{1e3 * q[len(q) // 2]:.3f}" for q in quarters if q),
          file=log)
    rec = SimpleNamespace(setup_s=setup_s, window_s=window_s,
                          latencies=latencies, attempted=attempted,
                          completed=attempted - failed, failed=failed,
                          trace=None, work=None)
    device_info = device_record(device, cell.spec.get("chips", 1))
    if trace:
        rec.trace = tracer.result(library_kernels(port.PACKAGE_DIR))
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
    entry.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limits = cell.cell["check"]["limits"]
    try:
        numbers, rec.work = entry.check()
    except Exception:
        traceback.print_exc(file=log)
        numbers = {k: float("inf") for k in limits}
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": limits[k]}
              for k in limits}
    correct = bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = load_module(metric_file(cell.base, m["name"]), "metric")
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        t = rec.trace
        out["breakdown"] = {
            "device_ops": top((o.name[:160], (o.end_us - o.start_us) / 1e6)
                              for o in t.ops),
            "idle_gaps": top((g[0][:160], g[1]) for g in t.gaps)}
    out["checks"] = checks
    return out
