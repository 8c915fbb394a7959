#!/usr/bin/env python3
"""Find every place where the host waits for the card on the benchmark's
request paths, under ``torch.cuda.set_sync_debug_mode("warn")``.

    python3 probes/sync_audit.py [--cells a,b] [--requests N]

For each cell of ``BENCHMARK.json`` (or those named), it sets the cell up
as ``portbench`` does, then runs its requests (``--requests``; a train
cell at least one fit and one step more, so a fit's start is seen) with
torch's synchronisation warnings on and every warning kept with the stack
of the port's frames that raised it. Where the port has its span registry
(``utils/trace.py``), the requests run with spans on and each warning is
also checked against it: it has to come from inside an ``rt.sync`` span,
and the ``host_sync`` counter a request is read beside the warnings a
request. Prints one JSON line and
writes it to ``chiprun_out/sync_audit.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
import warnings
from contextlib import nullcontext
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
# torch's own note, once, on turning the mode on
PROTOTYPE = "Synchronization debug mode is a prototype"
sys.path.insert(0, str(ROOT))


def _port_frames(stack) -> list:
    return [f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in stack
            if "raytracingincuda_torch" in f.filename]


def audit(name: str, requests: int, seed: int) -> dict:
    from portbench import harness

    try:
        from raytracingincuda_torch.utils import trace
    except ImportError:
        trace = None
    cell = harness.load_cell(ROOT, name)
    dev = torch.device("cuda", 0)
    _, entry = harness.set_up(cell, seed, dev)
    n = requests
    if "fit_steps" in cell.cell["params"]:
        n = max(n, cell.cell["params"]["fit_steps"] + 1)
    sites: dict = {}
    uncounted: dict = {}
    per_request = []

    def show(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(PROTOTYPE):
            return
        frames = _port_frames(traceback.extract_stack()[:-1])
        key = (" < ".join(frames[-3:][::-1])
               or f"outside the port: {Path(filename).name}:{lineno}")
        sites[key] = sites.get(key, 0) + 1
        if (frames and trace is not None
                and trace.innermost() != "rt.sync"):
            uncounted[key] = uncounted.get(key, 0) + 1

    old = warnings.showwarning
    warnings.showwarning = show
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            for j in range(n):
                before = sum(sites.values())
                syncs = trace.counts().get("host_sync", 0) if trace else 0
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with (trace.recording() if trace else nullcontext()):
                        entry.request(j)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                per_request.append({
                    "warnings": sum(sites.values()) - before,
                    "host_sync": (trace.counts().get("host_sync", 0) - syncs
                                  if trace else None)})
    finally:
        warnings.showwarning = old
    entry.release()
    return {"requests": n, "sites": sites, "uncounted": uncounted,
            "per_request": sorted({json.dumps(r) for r in per_request})}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=None)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sync_audit: no CUDA device", file=sys.stderr)
        return 2
    cells = (args.cells.split(",") if args.cells else
             [w["name"] for w in json.loads(
                 (ROOT / "BENCHMARK.json").read_text())["workloads"]])
    out = {"card": torch.cuda.get_device_name(0), "cells": {}}
    for name in cells:
        out["cells"][name] = audit(name, args.requests, args.seed)
        print(name, json.dumps(out["cells"][name]), file=sys.stderr,
              flush=True)
    dst = ROOT / "chiprun_out" / "sync_audit.json"
    dst.parent.mkdir(exist_ok=True)
    dst.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
