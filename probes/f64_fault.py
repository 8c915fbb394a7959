#!/usr/bin/env python3
"""Readings of the ``rtow_cover_f64.render`` check with a fault planted on
kernel 6, many seeds in one process, at the cell's own size:

    python3 probes/f64_fault.py --seeds 1 2 3 [--faults scaled half]
        [--requests 3]

``f64_kernel._f64`` (the f64 render's dispatcher, which every call site
looks up at call time) is wrapped for the whole of a seed's set-up,
requests and check: ``scaled`` multiplies its sums by 1 + 1e-3, ``half``
zeroes the sums of the second half of the lanes. Each seed runs
``portbench.control.readings`` in mode ``sound`` under the fault (the
benchmark's own faults patch other kernels). One JSON line a seed and
fault, then one with each fault's smallest reading; also written to
``chiprun_out/f64_fault.json``. Without a CUDA device it exits 2.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CELL = "rtow_cover_f64.render"


def _scaled(orig):
    return lambda *a, **kw: orig(*a, **kw) * (1.0 + 1e-3)


def _half(orig):
    def run(*a, **kw):
        out = orig(*a, **kw).clone()
        out[:, out.shape[1] // 2:] = 0.0
        return out

    return run


FAULTS = {"scaled": _scaled, "half": _half}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=list(FAULTS),
                    choices=list(FAULTS))
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("f64_fault: no CUDA device", file=sys.stderr)
        return 2
    from portbench import control
    from raytracingincuda_torch.ops import f64_kernel as fk

    lines, least = [], {}
    for name in args.faults:
        orig = fk._f64
        fk._f64 = FAULTS[name](orig)
        try:
            for seed in args.seeds:
                nums = control.readings(CELL, seed, "sound",
                                        torch.device("cuda"),
                                        requests=args.requests)
                line = {"workload": CELL, "fault": name, "seed": seed, **nums}
                print(json.dumps(line), flush=True)
                lines.append(line)
                for k, v in nums.items():
                    least[(name, k)] = min(v, least.get((name, k), v))
                torch.cuda.empty_cache()
        finally:
            fk._f64 = orig
    summary = {"workload": CELL, "min": {f"{f}.{k}": v
                                         for (f, k), v in least.items()}}
    print(json.dumps(summary), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "f64_fault.json").write_text(
        "\n".join(json.dumps(x) for x in [*lines, summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
