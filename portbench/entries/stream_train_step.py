"""Entry ``stream_train_step``: one step of ``make_stream_train``, the
streamed scene's inverse-rendering step: ``build_stream_arrays`` from the
current parameters, the fused walk, loss and gradients (kernels 4 and 5
and the segmented sum), ``chain_to_params`` and Adam's update.

Set-up prepares the stream once (``prepare_stream_scene``: Morton order,
blocks of the configuration's size; the step orders them front to back
at its first call) and renders the ground truth through ``render_stream``
in linear radiance for the fit's target; ``fit.Fit`` does the rest. The
reference walks no blocks: it tests every sphere, which gives the
streamed image but at exact ties between blocks.
"""
from __future__ import annotations

from portbench import fit, port


def _build(f):
    p, ctx = f.p, f.ctx
    sk = port.stream_kernel
    block = ctx.config["stream_block"]
    stream = sk.prepare_stream_scene(port.scene(f.truth), block=block)
    sm, bounds = sk.build_stream_arrays(port.scene(f.truth), stream.perm,
                                        stream.block,
                                        stream.scene_mat.shape[0])
    target = sk.render_stream(
        sk.StreamScene(sm, bounds, stream.block, stream.perm), f.cam,
        f.width, f.height, p["samples"], p["bounces"], seed=f.sampler_seed,
        gamma=p["gamma"])
    init_fn, step_fn = port.grad.make_stream_train(
        stream, f.width, f.height, p["samples"], p["bounces"],
        learning_rate=p["learning_rate"],
        trainable=port.trainable(p["trainable"]), seed=f.sampler_seed,
        fused=p["fused"], loss=p["loss"])
    return init_fn, step_fn, target


def make(ctx):
    return fit.Fit(ctx, _build)
