"""Entry ``render_f64``: one double-precision image through
``make_renderer(RenderConfig(dtype='float64', impl='kernel'))``, as a
user asks the port for a double render (``make_f64_renderer``, kernel 6).

Everything but the precision is ``render.Render``'s: set-up makes the
scene, draws the pixels the check compares and warms up; request j
renders at sampler seed (seed + j), and the harness keeps the float64
values at the drawn pixels. The check traces those pixels with the double
reference (``reference/tracer_f64.py``) and compares every value in
double: the render is one estimator, fixed bit for bit by its sampler and
the configuration's df64 contract, so a sound run reads 0. The control
is the same reference in float32, the precision below the
configuration's. The needed work is ``work_f64``'s.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import work, work_f64
from portbench.entries.render import Render
from portbench.reference import tracer, tracer_f64


class RenderF64(Render):
    def _cfg(self, seed: int):
        return dataclasses.replace(super()._cfg(seed),
                                   dtype=self.ctx.config["dtype"])

    def reference(self, j: int, dtype=torch.float64):
        """(the reference's values at the drawn pixels (P, 3), counts)."""
        p = self.p
        sc = tracer.scene_tensors(self.arrays, self.ctx.device, dtype)
        cam = tracer_f64.camera(self.ctx.config["camera"], self.width,
                                self.height, self.ctx.device, dtype)
        acc, counts = tracer_f64.radiance(
            sc, cam, self.ctx.seed + j, self.pix, self.width, p["samples"],
            p["bounces"], dtype=dtype)
        return tracer_f64.finish(acc, p["samples"]).t(), counts

    def check(self, control: bool = False):
        """({number: value}, the needed work of one render)."""
        worst, total = 0.0, dict.fromkeys(work.COUNT_KEYS, 0)
        reqs = self.checked()
        if not reqs:
            return {"pixel_max_abs_diff": float("inf")}, None
        for j in reqs:
            want, counts = self.reference(j)
            got = (self.reference(j, torch.float32)[0] if control
                   else self.kept[j])
            gap = float((got.double() - want).abs().max())
            worst = max(worst, gap if np.isfinite(gap) else float("inf"))
            for k in total:
                total[k] += counts[k]
        n = self.width * self.height
        per = work.scale(total, n / (len(reqs) * self.pix.numel()))
        return ({"pixel_max_abs_diff": worst},
                work_f64.needed(per, n, self.arrays["mat"].shape[0]))


def make(ctx):
    return RenderF64(ctx)
