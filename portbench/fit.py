"""Fitting loops: what the train entries share.

Set-up makes the ground truth (the configuration's scene) on the device,
renders it through the port once for the fits' target, builds the train
step with the cell's own sampler seed and trained leaves (``trainable``)
and drives it through its first step. The window carries the state on,
one step a request, as a fitting user does, in fits of ``fit_steps``
steps: fit i starts from the ground truth with its albedos jittered
(``scene.start``) and zero moments. The
sampler seed, the scenes, the starts and the target are the
configuration's and the cell's, never the run's ``--seed``, so every run
follows the same trajectories and does the same work, and a faster step
runs more fits of the same length.

The run's ``--seed`` draws what the check reads: pixels S, a second
target (the fit's own everywhere but on S, where it is higher by 1 + u, u
drawn from the seed), and the window's steps to judge (a reservoir of
``check.steps`` among those completed), besides the first. For each step
judged, kept as the window made it (the state it was given, the state it
returned, its loss), the check reruns the program's step from the same
state against the second target. The two steps differ only on S, so the
differences of their losses and of their gradients (read from Adam's
first moment, m' - m = (1 - beta1)(g - m)) hold only S's terms, which the
reference computes exactly from the pixels of S alone, at the cell's own
size, samples and depth. The numbers, worst over the steps judged:

- ``loss_gap``: |the program's loss difference - the reference's| over
  the reference's;
- ``grad_gap``: the worst trained leaf's gap between the norms of the
  two gradient differences, over the larger of that leaf's and the median
  trained leaf's reference norm;
- ``update_gap``: the parameters' change in the window's step against
  Adam (``torch.optim.Adam``'s defaults at the cell's rate) applied by the
  reference to the gradient in the program's moments, at the step's count
  as the benchmark counts it, in the same norm over the leaves whose
  reference gradient is above ``NOUGHT`` of the median leaf's.

The reference follows the program from the program's own state: it sees
S alone, so it cannot form the next state itself. The first step, from
fit 0's start and zero moments, is always judged.
"""
from __future__ import annotations

import numpy as np
import torch

from . import port, stats
from . import scene as bscene
from .reference import sampler, tracer

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
# leaves whose reference gradient is under this share of the median
# leaf's move under Adam by round-off alone: out of ``update_gap``
NOUGHT = 1e-3


class Fit:
    """``build(fit) -> (init_fn, step_fn, target (H, W, 3))`` makes the
    program's train step; the rest is the entries' common loop."""

    def __init__(self, ctx, build):
        self.ctx, self.p = ctx, ctx.cell["params"]
        ck, dev = ctx.cell["check"], ctx.device
        self.width, self.height = self.p["width"], self.p["height"]
        self.sampler_seed = self.p["sampler_seed"]
        self.fit_steps = self.p["fit_steps"]
        self.train = [i for i, k in enumerate(tracer.LEAVES)
                      if k in self.p["trainable"]]
        self.truth = bscene.make(ctx.config, dev)
        self.cam = port.camera(ctx.config["camera"])
        ctx.sync()
        ctx.phase("scenes")
        n = self.width * self.height
        rng = np.random.default_rng(ctx.seed)
        pix = np.sort(rng.choice(n, min(n, ck["pixels"]), replace=False))
        self.pix = torch.from_numpy(pix).to(dev)
        self.pick = np.random.default_rng([ctx.seed, 1])
        self.init_fn, self.step_fn, self.target = build(self)
        ctx.sync()
        ctx.phase("preparation and target")
        u = torch.rand((self.pix.numel(), 3),
                       generator=bscene.generator(ctx.seed, dev), device=dev)
        self.sibling = self.target.clone()
        self.sibling.view(-1, 3)[self.pix] += 1.0 + u
        self.count, self.state = 0, None
        self.first = self._step()
        self.kept: dict = {}
        ctx.sync()
        ctx.phase("first step")

    def _step(self):
        """One step of the fits: (its count within its fit, the state it
        was given, the state it returned, its loss)."""
        fit, t = divmod(self.count, self.fit_steps)
        if t == 0:
            self.state = self.init_fn(port.scene(bscene.start(
                self.ctx.config, self.truth, fit)).params)
        s_in = self.state
        self.state, loss = self.step_fn(s_in, self.cam, self.truth["mat"],
                                        self.truth["active"], self.target)
        self.count += 1
        return t + 1, s_in, self.state, loss

    def request(self, j: int):
        out = self._step()
        self.ctx.sync()
        return out

    def keep(self, j: int, out) -> None:
        """A reservoir of ``check.steps`` of the window's steps, each kept
        with the chance every other has (the states are new tensors a
        step: nothing is copied)."""
        if j < 0:
            return
        k = self.ctx.cell["check"]["steps"]
        if len(self.kept) < k:
            self.kept[j] = out
            return
        r = int(self.pick.integers(j + 1))
        if r < k:
            del self.kept[sorted(self.kept)[r]]
            self.kept[j] = out

    def release(self) -> None:
        self.state = None

    # -- the check ----------------------------------------------------------

    def reference(self, params: list, dtype=torch.float32):
        """(loss(target) - loss(sibling), the gradient's difference per
        leaf) from S alone, at ``params``."""
        p, dev = self.p, self.ctx.device
        arrays = dict(zip(tracer.LEAVES, params), mat=self.truth["mat"],
                      active=self.truth["active"])
        sc = tracer.scene_tensors(arrays, dev, dtype, requires_grad=True)
        cam = tracer.camera(self.ctx.config["camera"], self.width,
                            self.height, dev, dtype)
        acc, _ = tracer.radiance(sc, cam, self.sampler_seed, self.pix,
                                 self.width, p["samples"], p["bounces"],
                                 rr_start=p["rr_start"], dtype=dtype)
        lin = acc * sampler.f32(1.0 / p["samples"])
        img = tracer.gamma2(lin) if p["gamma"] else lin
        img = img.float()
        t0 = self.target.view(-1, 3)[self.pix].t()
        t1 = self.sibling.view(-1, 3)[self.pix].t()
        w = sampler.f32(1.0 / (3 * self.width * self.height))
        d_loss = w * float(((img - t0) ** 2 - (img - t1) ** 2).detach()
                           .double().sum())
        surrogate = (2.0 * w * (t1 - t0) * img).sum()
        grads = torch.autograd.grad(surrogate, [sc[k] for k in tracer.LEAVES],
                                    allow_unused=True)
        d_grad = [np.zeros(sc[k].shape) if g is None
                  else g.detach().double().cpu().numpy()
                  for g, k in zip(grads, tracer.LEAVES)]
        return d_loss, d_grad

    def judged(self) -> list:
        """The first step and the window's steps kept, in order."""
        return [self.first] + [self.kept[j] for j in sorted(self.kept)]

    def check(self, control: bool = False):
        """({number: value}, None); with ``control`` the reference in
        bfloat16 stands in the program's place."""
        loss_gap = grad_gap = update_gap = 0.0
        live = self.truth["active"].cpu().numpy()

        def host(leaves, rows=slice(None)):     # the trained leaves
            return [leaves[i].detach().double().cpu().numpy()[rows]
                    for i in self.train]

        for t, s_in, s_out, loss in self.judged():
            params = port.leaves(s_in.params)
            want_l, want_g = self.reference(params)
            want_g = [want_g[i] for i in self.train]
            # the live slots' values for the update (padding never moves)
            p_in, mu_in, nu_in, mu_out = (host(x, live) for x in (
                params, port.leaves(s_in.opt_state.mu),
                port.leaves(s_in.opt_state.nu),
                port.leaves(s_out.opt_state.mu)))
            if control:
                got_l, got_g = self.reference(params, dtype=torch.bfloat16)
                got_g = [got_g[i] for i in self.train]
                got_u = self.adam(p_in, mu_in, nu_in, mu_out, t,
                                  dtype=torch.bfloat16)
            else:
                b, loss_b = self.step_fn(s_in, self.cam, self.truth["mat"],
                                         self.truth["active"], self.sibling)
                got_l = float(loss) - float(loss_b)
                got_g = [(x - y) / (1 - BETA1) for x, y in zip(
                    host(port.leaves(s_out.opt_state.mu)),
                    host(port.leaves(b.opt_state.mu)))]
                got_u = [x - y for x, y in
                         zip(host(port.leaves(s_out.params), live), p_in)]
            want_u = self.adam(p_in, mu_in, nu_in, mu_out, t)
            norms = [np.linalg.norm(g) for g in want_g]
            on = [n >= NOUGHT * np.median(norms) for n in norms]
            loss_gap = max(loss_gap, _finite(stats.rel_gap(got_l, want_l)))
            grad_gap = max(grad_gap, _finite(
                stats.worst_leaf_norm_gap(got_g, want_g)))
            update_gap = max(update_gap, _finite(stats.worst_leaf_norm_gap(
                [g for g, k in zip(got_u, on) if k],
                [w for w, k in zip(want_u, on) if k])))
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "update_gap": update_gap}, None

    def adam(self, p, mu_in, nu_in, mu_out, t: int, dtype=torch.float64):
        """Adam's change of each leaf at count ``t``, from the gradient
        that the moments ``mu_in`` -> ``mu_out`` hold, worked out in
        ``dtype`` from the leaves as given."""
        lr, out = self.p["learning_rate"], []
        for x, m0, v0, m in zip(p, mu_in, nu_in, mu_out):
            xd, m0, v0, m = (torch.from_numpy(a).to(dtype)
                             for a in (x, m0, v0, m))
            g = (m - BETA1 * m0) / (1 - BETA1)
            v = BETA2 * v0 + (1 - BETA2) * g * g
            new = xd - lr * (m / (1 - BETA1 ** t)) / (
                (v / (1 - BETA2 ** t)).sqrt() + EPS)
            out.append(new.double().numpy() - x)
        return out


def _finite(x: float) -> float:
    return x if np.isfinite(x) else float("inf")
