"""The needed work of a double-precision render and the least time the
card could take (the ``rtow_cover_f64`` cells).

The segment counts, the Threefry blocks' integer operations and the
operation counts per segment are ``work.py``'s, from the traced segments
of ``reference/tracer_f64.py``; the scan over candidate spheres is not
counted, so no scan can push the share past 100%. The float operations
run on the FP64 pipe (a double render keeps its geometry, shading, sky
and sums in double), priced at 34 TFLOP/s, half the FP32 rate; the few
f32 operations of the draws are priced with them. Bytes: the scene read
once as f32 and the image written once as 8-byte values. The least time
is the largest of the FP64 operations over 34 TFLOP/s, the integer
operations over 33.5 TOP/s and the bytes over 3.35 TB/s, NVIDIA's H100
SXM figures at 700 W.
"""
from __future__ import annotations

from . import work

FP64_PER_S = 34e12


def needed(counts: dict, pixels: int, slots: int) -> dict:
    """Operations and bytes of a double render from its segment counts
    (``work.COUNT_KEYS``, already scaled to the whole image)."""
    w = work.needed(counts, pixels, slots)
    return {"fp64_ops": w["fp32_ops"], "int32_ops": w["int32_ops"],
            "bytes": float(slots * 11 * 4 + pixels * 3 * 8)}


def least_seconds(w: dict) -> float:
    return max(w["fp64_ops"] / FP64_PER_S, w["int32_ops"] / work.INT32_PER_S,
               w["bytes"] / work.BYTES_PER_S)
