"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed from the start of this module as ``setup_s``), a closed
loop of the cell's requests for ``--seconds``, each ended by a device
synchronise, then the check of the timed path's outputs against the
plain reference. The last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read under
``torch.profiler``), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared with its limit; those also end
standard error. Without a CUDA device (or with fewer than the cell asks
for) it exits 2 and prints no result; it exits 3 if the JAX stack or the
JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    chips = harness.load_cell(ROOT, args.workload).spec.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), root=ROOT,
                      device=torch.device("cuda", 0), t0=T0)
    bad = harness.fenced_modules()
    if bad:
        print(f"portbench: fenced modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    out = _finite(out)
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def _finite(x):
    """The object with every non-finite float as None (plain JSON)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
