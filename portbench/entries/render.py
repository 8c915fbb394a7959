"""Entry ``render``: one image through ``make_renderer``, as a renderer's
user calls it.

Set-up makes the scene on the device, draws the pixels the check
compares from the seed, and renders once to warm up. Request j builds the
renderer for sampler seed (seed + j) and renders; the harness then keeps
the image's values at the drawn pixels. The check draws requests from
the seed, traces their drawn pixels with the reference at the cell's
size, samples and depth, and compares every value: the render is one
estimator, fixed bit for bit by its sampler, so a sound run reads 0.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import port, work
from portbench import scene as bscene
from portbench.reference import sampler, tracer


class Render:
    def __init__(self, ctx):
        self.ctx, self.p = ctx, ctx.cell["params"]
        self.width, self.height = self.p["width"], self.p["height"]
        self.arrays = bscene.make(ctx.config, ctx.device)
        self.scene = port.scene(self.arrays)
        ctx.sync()
        ctx.phase("scene")
        self.cam = port.camera(ctx.config["camera"])
        rng = np.random.default_rng(ctx.seed)
        n = self.width * self.height
        pix = np.sort(rng.choice(n, min(n, ctx.cell["check"]["pixels"]),
                                 replace=False))
        self.pix = torch.from_numpy(pix).to(ctx.device)
        self.kept: dict = {}
        self.keep(-1, self.request(-1))        # warm-up
        self.kept.clear()

    def _cfg(self, seed: int):
        p = self.p
        return port.RenderConfig(
            scene_id=1, width=self.width, height=self.height,
            samples=p["samples"], bounces=p["bounces"], layout=p["layout"],
            impl=p["impl"], rr_start=p["rr_start"], seed=seed)

    def request(self, j: int):
        img = port.make_renderer(self._cfg(self.ctx.seed + j),
                                 self.ctx.device)(self.scene, self.cam)
        self.ctx.sync()
        return img

    def keep(self, j: int, img) -> None:
        self.kept[j] = img.reshape(-1, 3).index_select(0, self.pix)

    def release(self) -> None:
        self.scene = None

    def reference(self, j: int, dtype=torch.float32):
        """(the reference's values at the drawn pixels (P, 3), counts)."""
        p = self.p
        sc = tracer.scene_tensors(self.arrays, self.ctx.device, dtype)
        cam = tracer.camera(self.ctx.config["camera"], self.width,
                            self.height, self.ctx.device, dtype)
        acc, counts = tracer.radiance(
            sc, cam, self.ctx.seed + j, self.pix, self.width, p["samples"],
            p["bounces"], rr_start=p["rr_start"], dtype=dtype)
        img = tracer.gamma2(acc.float() * sampler.f32(1.0 / p["samples"]))
        return img.t(), counts

    def checked(self) -> list:
        """The requests the check compares, drawn from the seed among
        those the window completed."""
        done = sorted(self.kept)
        k = min(len(done), self.ctx.cell["check"]["requests"])
        rng = np.random.default_rng(self.ctx.seed + 1)
        return sorted(int(done[i]) for i in rng.choice(len(done), k,
                                                        replace=False))

    def check(self, control: bool = False):
        """({number: value}, the needed work of one render)."""
        worst, total = 0.0, dict.fromkeys(work.COUNT_KEYS, 0)
        reqs = self.checked()
        if not reqs:
            return {"pixel_max_abs_diff": float("inf")}, None
        for j in reqs:
            want, counts = self.reference(j)
            got = (self.reference(j, torch.bfloat16)[0] if control
                   else self.kept[j])
            gap = float((got.float() - want).abs().max())
            worst = max(worst, gap if np.isfinite(gap) else float("inf"))
            for k in total:
                total[k] += counts[k]
        n = self.width * self.height
        per = work.scale(total, n / (len(reqs) * self.pix.numel()))
        return ({"pixel_max_abs_diff": worst},
                work.needed(per, n, self.arrays["mat"].shape[0]))


def make(ctx):
    return Render(ctx)
