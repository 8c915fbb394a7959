"""Entry ``train_step``: one step of ``make_train_step(impl='fused')``, as
an inverse-rendering user fits a scene: the render, the loss, the
gradients of every scene leaf, ``chain_to_params`` and Adam's update.

Set-up makes the difficulty order once (``measure_difficulty``,
``difficulty_order``; it changes speed only, so the reference needs
none) and renders the ground truth through ``make_renderer`` for the
fit's target; ``fit.Fit`` does the rest.
"""
from __future__ import annotations

from portbench import fit, port


def _build(f):
    p, ctx = f.p, f.ctx
    seed = f.sampler_seed
    truth = port.scene(f.truth)
    target = port.make_renderer(port.RenderConfig(
        scene_id=1, width=f.width, height=f.height, samples=p["samples"],
        bounces=p["bounces"], rr_start=p["rr_start"], seed=seed),
        ctx.device)(truth, f.cam)
    pd, ps = p["difficulty_order"]
    order = port.render_kernel.difficulty_order(
        port.render_kernel.measure_difficulty(
            port.scene(f.truth), f.cam, f.width, f.height, pd, ps,
            seed=seed), pd, ps)
    init_fn, step_fn = port.grad.make_train_step(
        f.width, f.height, p["samples"], p["bounces"],
        learning_rate=p["learning_rate"],
        trainable=port.trainable(p["trainable"]), impl="fused", seed=seed,
        pixel_order=order, rr_start=p["rr_start"], gamma=p["gamma"],
        loss=p["loss"])
    return init_fn, step_fn, target


def make(ctx):
    return fit.Fit(ctx, _build)
