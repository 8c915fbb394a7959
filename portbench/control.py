"""Readings of a cell's check for setting its limits, many seeds in one
process, at the cell's own size:

    python3 -m portbench.control --workload <cell> --mode <mode> --seeds 1 2 3

``--mode sound``: the port as it is (the lower readings); ``control``:
the reference in bfloat16, the precision below the configuration's
float32, in the port's place; a fault of ``faults.NAMES`` planted under
the timed path. A seed runs the cell's set-up, a short window of
``--requests`` requests back to back at the cell's own size, and the
check, with the fault planted throughout. One JSON line a seed, then one
with each number's largest and smallest reading. Without a CUDA device it
exits 2.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from portbench import faults

ROOT = Path(__file__).resolve().parent.parent


def readings(name: str, seed: int, mode: str, device, root: Path = ROOT,
             requests: int = 8):
    """The check's numbers for one seed under ``mode``."""
    from portbench import harness

    cell = harness.load_cell(root, name)
    with faults.planted(mode if mode in faults.NAMES else None):
        _, entry = harness.set_up(cell, seed, device)
        for j in range(requests):
            entry.keep(j, entry.request(j))
        entry.release()
        numbers, _ = entry.check(control=mode == "control")
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", default="sound",
                    choices=("sound", "control", *faults.NAMES))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=8)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    seen: dict = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = readings(args.workload, seed, args.mode, device,
                        requests=args.requests)
        for k, v in nums.items():
            seen.setdefault(k, []).append(v)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, **nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "seeds": len(args.seeds),
                      "max": {k: max(v) for k, v in seen.items()},
                      "min": {k: min(v) for k, v in seen.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
