"""Exact ties of the closest hit, which the streamed walk may break
another way than the brute force.

The streamed walk (kernels 4 and 5) gives the brute-force image but at
exact ties between blocks: where two spheres give one hit distance t =
root * (1 / a) in float32, the walk keeps the one in the block it visited
first, the brute force the smaller root numerator, then the lower slot.
``radiance`` is ``tracer.radiance`` with each lane marked from the bounce
at which such a tie decides its hit (two or more active spheres at the
winner's t): from there the lane follows a marker slot whose every value
is NaN, so a pixel that met a tie sums to NaN and a check can leave it
out. A lane that met no tie gets the same bits as from ``tracer``.
"""
from __future__ import annotations

import math

import torch

from . import tracer


def tied(sc: dict, o, d):
    """Per ray: two or more active slots give a valid root with the
    smallest t = root * (1 / a)."""
    ids = sc["scan_ids"]
    cx, cy, cz, r = (sc[k].detach()[ids][:, None].to(o.x.dtype)
                     for k in ("cx", "cy", "cz", "radius"))
    lanes = o.x.shape[0]
    step = max(1, tracer._SCAN_ELEMS // max(1, ids.shape[0]))
    out = torch.zeros(lanes, dtype=torch.bool, device=o.x.device)
    with torch.no_grad():
        for lo in range(0, lanes, step):
            sl = slice(lo, lo + step)
            oo = tracer.Vec3(*(t.detach()[sl][None, :] for t in o))
            dd = tracer.Vec3(*(t.detach()[sl][None, :] for t in d))
            root, valid, a = tracer._roots(cx, cy, cz, r, oo, dd, tracer.T_MIN)
            t = torch.where(valid, root * (1.0 / a),
                            torch.full_like(root, math.inf))
            best = t.min(0, keepdim=True).values
            out[sl] = ((t == best) & valid).sum(0) >= 2
    return out


def _marking(closest, marker: int):
    def run(sc, o, d):
        hit, win = closest(sc, o, d)
        tie = hit & tied(sc, o, d)
        return hit, torch.where(tie, torch.full_like(win, marker), win)

    return run


def radiance(sc: dict, *args, **kw):
    """``tracer.radiance(sc, *args, **kw)`` with the lanes that meet an
    exact tie marked: their pixels' sums are NaN."""
    n = sc["mat"].shape[0]
    marked = dict(sc)
    for k in tracer.LEAVES:
        marked[k] = torch.cat([sc[k], sc[k].new_full((1,), math.nan)])
    marked["mat"] = torch.cat([sc["mat"], sc["mat"].new_zeros(1)])
    plain = tracer.closest
    tracer.closest = _marking(plain, n)
    try:
        return tracer.radiance(marked, *args, **kw)
    finally:
        tracer.closest = plain
