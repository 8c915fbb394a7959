"""Entry ``stream_render``: one frame of a streamed scene through one
renderer of ``make_renderer(impl='stream')``, as a user re-renders a
prepared scene.

Set-up makes the scene on the device, draws the pixels the check
compares from the seed, makes one renderer at the cell's sampler seed,
prepares its stream (``renderer.prepare``: Morton blocks of the
configuration's size) and renders once to warm up; that render orders the
blocks front to back from the camera. Request j renders the same frame
again through that renderer, so the stream is not prepared again (a new
renderer prepares its own). The check traces the drawn pixels at the same
sampler seed with the reference, which tests every sphere. The streamed
walk gives that image but at exact ties between blocks (the
configuration's guarantee), so the reference marks the pixels whose paths
meet an exact tie of the closest hit (``reference/ties.py``); the
number compared is the largest difference of any value at the other drawn
pixels, and a sound run reads 0. How many drawn pixels met a tie ends
standard error. Everything else is ``render.Render``'s.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from portbench import port, work
from portbench.entries.render import Render
from portbench.reference import sampler, ties, tracer


class StreamRender(Render):
    def __init__(self, ctx):
        self.renderer = None
        super().__init__(ctx)

    def _cfg(self, seed: int):
        return dataclasses.replace(
            super()._cfg(seed), stream_block=self.ctx.config["stream_block"])

    def request(self, j: int):
        if self.renderer is None:      # set-up: the renderer and its stream
            self.renderer = port.make_renderer(
                self._cfg(self.p["sampler_seed"]), self.ctx.device)
            self.renderer.prepare(self.scene)
            self.ctx.sync()
            self.ctx.phase("stream")
        img = self.renderer(self.scene, self.cam)
        self.ctx.sync()
        return img

    def release(self) -> None:
        self.renderer = None
        super().release()

    def reference(self, j: int, dtype=torch.float32):
        """(the reference's values at the drawn pixels (P, 3), counts) of
        the one frame every request renders; in float32 NaN at the pixels
        that met an exact tie."""
        p = self.p
        sc = tracer.scene_tensors(self.arrays, self.ctx.device, dtype)
        cam = tracer.camera(self.ctx.config["camera"], self.width,
                            self.height, self.ctx.device, dtype)
        trace = ties.radiance if dtype == torch.float32 else tracer.radiance
        acc, counts = trace(sc, cam, p["sampler_seed"], self.pix, self.width,
                            p["samples"], p["bounces"], rr_start=p["rr_start"],
                            dtype=dtype)
        img = tracer.gamma2(acc.float() * sampler.f32(1.0 / p["samples"]))
        # gamma2 floors NaN at black: a tie's mark is kept past it
        img = torch.where(torch.isfinite(acc), img, acc.float())
        return img.t(), counts

    def check(self, control: bool = False):
        """({number: value}, the needed work of one render)."""
        reqs = self.checked()
        if not reqs:
            return {"pixel_max_abs_diff": float("inf")}, None
        want, counts = self.reference(0)
        clear = torch.isfinite(want).all(1)
        print(f"check: {int((~clear).sum())} of the {clear.numel()} drawn "
              "pixels met an exact tie of the closest hit; left out",
              file=sys.stderr)
        ctl = self.reference(0, torch.bfloat16)[0] if control else None
        worst = 0.0
        for j in reqs:
            got = ctl if control else self.kept[j]
            gap = float((got.float() - want)[clear].abs().max()) if bool(
                clear.any()) else 0.0
            worst = max(worst, gap if np.isfinite(gap) else float("inf"))
        n = self.width * self.height
        per = work.scale(counts, n / self.pix.numel())
        return ({"pixel_max_abs_diff": worst},
                work.needed(per, n, self.arrays["mat"].shape[0]))


def make(ctx):
    return StreamRender(ctx)
