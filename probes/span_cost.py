#!/usr/bin/env python3
"""What the port's spans cost when on, and how their clock agrees with
the profiler's on the card.

    python3 probes/span_cost.py [--cells a,b] [--pairs 3] [--requests 10]
        [--profiled 20]

For each cell of ``BENCHMARK.json`` (or those named), set up as
``portbench`` sets it up, in one process:

- cost: ``--pairs`` pairs of turns, each ``--requests`` requests with
  spans off, then as many inside ``utils/trace.recording()`` (no
  profiler), each request ended by a device synchronise and timed on the
  host clock; the median request of each turn, and the change from off
  to on;
- under ``torch.profiler`` (CPU and CUDA), one untimed request, then
  ``--profiled`` marked as ``portbench`` marks its window: each span's
  record against the profiler's event of the same name that starts
  nearest to it (the distribution of the differences of their starts,
  profiler minus record, in microseconds), and the device's idle time
  between the window's operations a request, by the innermost port span
  open, beside ``portbench``'s naming of the same gaps by host operation.

Prints one JSON line and writes it to ``chiprun_out/span_cost.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _turn(entry, j0: int, n: int, on: bool) -> float:
    from raytracingincuda_torch.utils import trace

    times = []
    for j in range(j0, j0 + n):
        t = time.perf_counter()
        if on:
            with trace.recording():
                entry.request(j)
        else:
            entry.request(j)
        times.append(time.perf_counter() - t)
    trace.reset()
    return 1e3 * statistics.median(times)


def _profiled(entry, j0: int, n: int) -> dict:
    """``n`` requests (after one untimed) under the profiler, marked as
    ``portbench`` marks its window: the clock's agreement and the idle
    time by innermost port span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import spans, trace as btrace
    from raytracingincuda_torch.utils import trace

    trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        entry.request(j0)
        with record_function(btrace.WINDOW_MARK):
            for j in range(j0 + 1, j0 + 1 + n):
                with record_function(btrace.REQUEST_MARK):
                    entry.request(j)
    events = list(prof.profiler.kineto_results.events())
    recs = trace.records()
    trace.reset()
    by_name: dict = {}
    for e in events:
        if e.name().startswith("rt.") and "CPU" in str(e.device_type()):
            by_name.setdefault(e.name(), []).append(e.start_ns())
    diffs, unmatched = [], 0
    for r in recs:
        starts = by_name.get(r.name)
        if not starts:
            unmatched += 1
            continue
        d = min(starts, key=lambda s: abs(s - r.start_ns)) - r.start_ns
        diffs.append(d / 1e3)
    q = statistics.quantiles(diffs, n=4)
    clock = {"records": len(diffs), "unmatched": unmatched,
             "us_min": min(diffs), "us_q1": q[0], "us_median": q[1],
             "us_q3": q[2], "us_max": max(diffs)}
    t = btrace.reduce(events, frozenset())
    w = spans.window(SimpleNamespace(trace=t), recs)
    return {"clock": clock, "idle_pct": btrace.idle_pct(t),
            "idle_ms_by_innermost_span": _idle_by_span(w, t.ops),
            "gap_ms_by_host_op_and_span": _cross(w, events, t),
            "gap_ms_by_host_op": {k: 1e3 * v / t.requests
                                  for k, v in btrace.top(t.gaps, 8)}}


def _cross(w, events, t) -> dict:
    """For the host operations that name the most idle (``portbench``'s
    naming, by the gap's middle), the innermost port span open at each
    gap's middle: milliseconds a request."""
    from portbench import spans, trace as btrace

    host = {ev.name() for ev in events if "CPU" in str(ev.device_type())}
    cpu = sorted((ev.start_ns() / 1e3, ev.start_ns() / 1e3
                  + ev.duration_ns() / 1e3, ev.name()) for ev in events
                 if not btrace._device_op(ev, host)
                 and "CPU" in str(ev.device_type())
                 and not ev.name().startswith("portbench."))
    starts = [c[0] for c in cpu]
    recs = sorted((w.recs[i].start_ns / 1e3, w.recs[i].end_ns / 1e3,
                   w.recs[i].name) for i in w.inside if w.recs[i].end_ns)
    out: dict = {}
    for a, b in spans.idle_gaps(t.ops, w.lo_ns / 1e3, w.hi_ns / 1e3):
        name, _ = btrace._gap(a, b, cpu, starts)
        mid = 0.5 * (a + b)
        inner = [r for r in recs if r[0] <= mid <= r[1]]
        span = max(inner)[2] if inner else "outside the port's spans"
        row = out.setdefault(name, {})
        row[span] = row.get(span, 0.0) + (b - a) / 1e3 / w.requests
    top = sorted(out.items(), key=lambda kv: -sum(kv[1].values()))[:6]
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1])[:5])
            for k, v in top}


def _idle_by_span(w, ops) -> dict:
    """Idle milliseconds a request between the window's device operations,
    by the innermost port span open ("outside the port's spans" where
    none is)."""
    from portbench import spans

    marks = []
    for i in w.inside:
        r = w.recs[i]
        if r.end_ns:
            marks += [(r.start_ns / 1e3, 1, i), (r.end_ns / 1e3, 0, i)]
    marks.sort()
    segs, stack, t0 = [], [], w.lo_ns / 1e3
    for t, opening, i in marks:
        segs.append((t0, t, w.recs[stack[-1]].name if stack else None))
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        t0 = t
    segs.append((t0, w.hi_ns / 1e3, None))
    out: dict = {}
    k = 0
    for a, b in spans.idle_gaps(ops, w.lo_ns / 1e3, w.hi_ns / 1e3):
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            s0, s1, name = segs[j]
            d = min(b, s1) - max(a, s0)
            if d > 0:
                key = name or "outside the port's spans"
                out[key] = out.get(key, 0.0) + d / 1e3 / w.requests
            j += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=None)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--profiled", type=int, default=20)
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        return 2
    from portbench import harness

    cells = (args.cells.split(",") if args.cells else
             [w["name"] for w in json.loads(
                 (ROOT / "BENCHMARK.json").read_text())["workloads"]])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"card": card, "cells": {}}
    for name in cells:
        cell = harness.load_cell(ROOT, name)
        _, entry = harness.set_up(cell, args.seed, torch.device("cuda", 0))
        j, turns = 0, []
        for _ in range(args.pairs):
            off = _turn(entry, j, args.requests, False)
            on = _turn(entry, j + args.requests, args.requests, True)
            j += 2 * args.requests
            turns.append({"off_ms": off, "on_ms": on,
                          "on_over_off_pct": 100.0 * (on / off - 1.0)})
        res = {"turns": turns, **_profiled(entry, j, args.profiled)}
        entry.release()
        out["cells"][name] = res
        print(name, json.dumps(res), file=sys.stderr, flush=True)
    dst = ROOT / "chiprun_out" / "span_cost.json"
    dst.parent.mkdir(exist_ok=True)
    dst.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
