"""Adaptive sampling: per-pixel Monte-Carlo budgets from measured variance.

The counterpart of ``raytracingincuda_tpu/ops/adaptive.py``. The counter-
based RNG (``ops/rng.py``) keys every draw on (pixel, sample, bounce,
draw), so pixel p's samples are global ids and raw radiance sums of
disjoint sample windows add up exactly: a multi-pass schedule is the same
estimator as one pass at the final per-pixel counts.

Schedule (the split-buffer error estimate):
  1. probe: render ``base_spp`` samples as two half-buffers A = [0, k) and
     B = [k, 2k), one launch each;
  2. plan: e_p = |lum(A/k) - lum(B/k)| / max(lum((A + B) / 2k), 0.05), the
     split-buffer estimate of the pixel's relative standard error, dilated
     and blurred over 3x3 neighbourhoods (``_dilate_blur``); then
     extra_p = clip(round(n_p (e_p / tol)^2 - n_p), 0, max_spp - n_p);
  3. refine: one launch renders samples [base_spp, base_spp + extra_p)
     with the per-lane budget row;
  4. finish: image = (A + B + C) / (base_spp + extra_p), gamma.

With ``rounds`` > 1 each refine renders its budget as two half-budget
launches added to A and B, so the error can be estimated again at the new
counts and refined again. Round r draws from the disjoint sample-id
windows base + (2r) w_cap and base + (2r + 1) w_cap, w_cap = max(max_spp -
base_spp, 2): the RNG needs distinct ids, not contiguous ones. A round
whose budgets are all zero ends the loop; that test is the one host sync a
round takes here (each budgeted launch checks its budgets' range on the
host as well, ``kernel_io.lane_setup``, and each launch copies its
camera row to the card).

Every phase is a render of raw sums on the scene's device: kernel 1
(``render_kernel.render_kernel``, layout ``vmem``) or, with ``stream=``,
kernel 4 (``stream_kernel.render_stream``); on CPU tensors their plain
versions. The plan and the finish are tensor code on the same device.
Budgets depend only on samples already drawn and each pixel's estimate is
the mean of all its samples, so the image is unbiased given the budget
schedule. Adaptive sampling is forward-only: there is no gradient through
a budget.

``mesh`` (``parallel/mesh.py``): every phase renders sharded and its raw
sums reach every rank (the renders' one ``all_reduce`` each), so every
rank computes the same plan on the whole image (the blur and dilation
cross pixels); the refine's bucket order covers the lanes of every rank.
``ray_tile``, ``interpret`` and ``stream_lane_group`` shaped the TPU
schedule and are ignored.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.camera import CameraConfig
from ..models.scene import Scene
from ..parallel import mesh as meshlib
from . import render_kernel as rk
from . import rng as rtrng
from .stream_kernel import render_stream
from .tracer import linear_to_gamma

_LUM = (0.2126, 0.7152, 0.0722)
# budgets are quantised into this many buckets for the refine's pixel order
N_BUCKETS = 32


def _luminance(img: torch.Tensor) -> torch.Tensor:
    return (_LUM[0] * img[..., 0] + _LUM[1] * img[..., 1]
            + _LUM[2] * img[..., 2])


class AdaptiveResult(NamedTuple):
    image: torch.Tensor       # (H, W, 3), gamma per the call
    spp_map: torch.Tensor     # (H, W) int32 final per-pixel sample counts
    error_map: torch.Tensor   # (H, W) relative split-buffer error estimate


def split_buffer_error(a_acc: torch.Tensor, b_acc: torch.Tensor,
                       half) -> torch.Tensor:
    """Relative per-pixel error from two half-buffers of raw radiance
    sums (H, W, 3). ``half`` is the per-buffer sample count: a scalar, or
    an (H, W) per-pixel tensor (multi-round schedules)."""
    half = torch.as_tensor(half, dtype=a_acc.dtype, device=a_acc.device)
    if half.dim():
        half = half[..., None]
    a = a_acc / half
    b = b_acc / half
    mean_lum = _luminance((a + b) * 0.5)
    diff_lum = (_luminance(a) - _luminance(b)).abs()
    # the floor keeps dark pixels from demanding unbounded relative precision
    return diff_lum / torch.clamp_min(mean_lum, 0.05)


def _dilate_blur(err: torch.Tensor) -> torch.Tensor:
    """3x3 max (dilate), then 3x3 mean (blur) of an (H, W) error map, with
    the edge replicated.

    The split-buffer estimate at probe counts is itself noisy: a firefly
    path the probe never sampled reads as converged. Dilating lets a noisy
    pixel protect its neighbours, and blurring removes single-pixel
    flukes. The nine shifts add in order from 0 and the sum is divided by
    9, as the JAX package computes it."""
    def shifts(x):
        p = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1),
                                    mode="replicate")[0, 0]
        h, w = x.shape
        return [p[i:i + h, j:j + w] for i in range(3) for j in range(3)]

    mx = err
    for s in shifts(err):
        mx = torch.maximum(mx, s)
    return sum(shifts(mx)) / 9.0


def budgets_from_error(err: torch.Tensor, base_spp, max_spp: int, tol: float,
                       smooth: bool = True) -> torch.Tensor:
    """Extra samples per pixel (int32) under 1/sqrt(n) error scaling.
    ``base_spp`` is the current per-pixel count: a scalar, or an (H, W)
    tensor (multi-round schedules plan again at unequal counts). Rounds
    half to even."""
    plan_err = _dilate_blur(err) if smooth else err
    counts = torch.as_tensor(base_spp, dtype=torch.float32,
                             device=err.device)
    ratio = plan_err / tol
    want = counts * (ratio * ratio)
    extra = torch.minimum(torch.clamp_min(torch.round(want - counts), 0),
                          max_spp - counts)
    return extra.to(torch.int32)


def bucket_order(extra: torch.Tensor, max_extra_cap: int,
                 padded: int) -> torch.Tensor:
    """(padded,) int32 pixel order for a refine: the budgets (padded with
    zeros) quantised into ``N_BUCKETS`` buckets and stably sorted, so that
    a warp holds pixels of similar budgets. Equal to the JAX package's
    counting sort (``pallas_kernel._bucket_order``) on the same buckets."""
    flat = torch.zeros(padded, dtype=torch.int32, device=extra.device)
    flat[:extra.numel()] = extra.reshape(-1)
    q = torch.div(flat * N_BUCKETS, max(max_extra_cap, 1),
                  rounding_mode="floor").clamp(0, N_BUCKETS - 1)
    return torch.argsort(q, stable=True).to(torch.int32)


def plan(a_acc: torch.Tensor, b_acc: torch.Tensor, counts: torch.Tensor, *,
         max_spp: int, tol: float, rounds: int = 1):
    """(error map, extra samples (H, W) int32) at the per-pixel ``counts``
    (H, W) int32: the public helpers, with budgets evened for the two
    half-budget launches of a multi-round schedule."""
    err = split_buffer_error(a_acc, b_acc, torch.clamp_min(counts // 2, 1))
    extra = budgets_from_error(err, counts, max_spp, tol)
    if rounds > 1:
        extra = (extra // 2) * 2
    return err, extra


def sample_windows(base_spp: int, max_spp: int, rounds: int) -> list:
    """The refine launches' (samples, sample_offset) a round: one window
    for ``rounds`` == 1, else two disjoint windows a round."""
    cap = max_spp - base_spp
    if rounds == 1:
        return [[(max(cap, 1), base_spp)]]
    w_cap = max(cap, 2)
    return [[(max(w_cap // 2, 1), base_spp + (2 * r) * w_cap),
             (max(w_cap // 2, 1), base_spp + (2 * r + 1) * w_cap)]
            for r in range(rounds)]


def render_adaptive(
    scene: Scene,
    cam_cfg: CameraConfig,
    img_width: int,
    img_height: int,
    max_depth: int,
    *,
    base_spp: int = 16,
    max_spp: int = 256,
    tol: float = 0.05,
    seed: int = rtrng.DEFAULT_SEED,
    gamma: bool = True,
    ray_tile: Optional[int] = None,
    mesh=None,
    interpret: bool = False,
    rr_start=None,
    legacy_sky: bool = False,
    rounds: int = 1,
    stream=None,
    stream_lane_group: int = 0,
) -> AdaptiveResult:
    """Adaptive render on the scene's device: probe at ``base_spp``, then
    refine noisy pixels up to ``max_spp``.

    ``rounds`` > 1 estimates the error again after each refine and refines
    again (two half-budget launches a round, from the round's own sample
    windows); a round whose budgets are all zero ends the loop. The total
    per-pixel count is capped at ``max_spp``. ``stream``, a prepared
    ``stream_kernel.StreamScene`` of ``scene``, renders every phase on the
    stream kernel. ``base_spp`` must be even. ``mesh``
    (``parallel.mesh.Mesh``) shards every phase's lanes over its ranks;
    every rank returns the same result, the same bits as one process."""
    del ray_tile, interpret, stream_lane_group
    if base_spp % 2 != 0:
        raise ValueError("base_spp must be even (two half-buffers)")
    if max_spp < base_spp:
        # clip(x, 0, negative) gives the negative bound: budgets would go
        # negative and corrupt the per-pixel counts
        raise ValueError(
            f"max_spp ({max_spp}) must be >= base_spp ({base_spp})")
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    if stream is not None and legacy_sky:
        raise ValueError("streamed adaptive has no legacy_sky")
    windows = sample_windows(base_spp, max_spp, rounds)
    last_spp, last_offset = windows[-1][-1]
    rtrng.validate_stream_ids(last_offset + last_spp, max_depth)

    def phase(spp, offset, budgets=None, order=None):
        kw = dict(seed=seed, gamma=False, accumulate_only=True,
                  rr_start=rr_start, sample_offset=offset,
                  sample_budgets=budgets, pixel_order=order, mesh=mesh)
        if stream is not None:
            return render_stream(stream, cam_cfg, img_width, img_height, spp,
                                 max_depth, **kw)
        return rk.render_kernel(scene, cam_cfg, img_width, img_height, spp,
                                max_depth, layout="vmem",
                                legacy_sky=legacy_sky, **kw)

    half = base_spp // 2
    a_cum = phase(half, 0)
    b_cum = phase(half, half)
    counts = torch.full(a_cum.shape[:2], base_spp, dtype=torch.int32,
                        device=a_cum.device)
    padded = meshlib.padded_lanes(img_width * img_height, mesh)
    err = None
    for launches in windows:
        err, extra = plan(a_cum, b_cum, counts, max_spp=max_spp, tol=tol,
                          rounds=rounds)
        if int(extra.max()) == 0:
            break
        order = bucket_order(extra, max_spp - base_spp, padded)
        if rounds == 1:
            (spp, offset), = launches
            a_cum = a_cum + phase(spp, offset, extra.reshape(-1), order)
        else:
            half_budget = (extra // 2).reshape(-1)
            (spp_a, off_a), (spp_b, off_b) = launches
            a_cum = a_cum + phase(spp_a, off_a, half_budget, order)
            b_cum = b_cum + phase(spp_b, off_b, half_budget, order)
        counts = counts + extra
    img = (a_cum + b_cum) / counts[..., None].to(a_cum.dtype)
    if gamma:
        img = linear_to_gamma(img)
    return AdaptiveResult(image=img, spp_map=counts, error_map=err)
