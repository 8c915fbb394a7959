"""Run configuration: the reference's six CLI flags plus the port's axes.

Field names and ``output_filename()`` are the JAX package's
(``raytracingincuda_tpu/config.py``), so a config and the file it names
carry over unchanged. What this port serves:

  dtype:  float32 ('float' in the file name) |
          float64 ('double': the render in double. ``impl='kernel'`` is
          the f64 kernel, in the JAX df64 kernel's scope: ``layout`` vmem
          or hbm, the parity estimator, the current-bounce sky.
          ``impl='oracle'`` is the f64 oracle, as JAX's native-f64
          oracle: either estimator, ``legacy_sky``, any layout (the
          oracle ignores it). Other impls have no f64 path.)
  layout: vmem ('const': the scene staged in shared memory) |
          hbm ('global': the scene read from device memory) |
          packed ('tex': the texture-path analog; ``impl='kernel'``
          renders it on the stream kernel, as JAX's 'pallas' does)
  impl:   kernel (the CUDA regeneration kernel; the JAX 'pallas') |
          stream (the stream kernel: scenes of any size, walked in culled
          sphere blocks of ``stream_block`` rows) |
          adaptive (per-pixel sample budgets, ``ops/adaptive.py``:
          ``samples`` is the probe, ``max_samples`` the cap, default 4x
          ``samples``; the regen kernel, or the stream kernel above 4096
          slots) |
          oracle (the plain PyTorch tracer)

``threads``, ``chunk_pixels``, ``pixels_per_lane``, ``ray_tile`` and
``stream_lane_group`` shaped the TPU schedule; here they are hints the
CUDA kernels ignore (``chunk_pixels`` still sizes the oracle's pixel
chunks).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .ops.rng import DEFAULT_SEED

DTYPE_NAMES = {"float32": "float", "float64": "double"}
LAYOUT_NAMES = {"hbm": "global", "vmem": "const", "packed": "tex"}
IMPLS = ("kernel", "stream", "adaptive", "oracle")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    scene_id: int
    width: int = 320
    height: int = 192
    samples: int = 10
    bounces: int = 25
    threads: int = 8          # file-name parity; schedule hint only
    dtype: str = "float32"
    layout: str = "vmem"
    impl: str = "kernel"
    seed: int = DEFAULT_SEED
    legacy_sky: bool = False
    chunk_pixels: Optional[int] = None
    # Russian-roulette start depth (None = off = the reference estimator)
    rr_start: Optional[int] = None
    # impl='adaptive': the per-pixel cap (None = 4x samples), the target
    # relative error and the refine rounds
    max_samples: Optional[int] = None
    adaptive_tol: float = 0.05
    adaptive_rounds: int = 1
    pixels_per_lane: Optional[int] = None   # TPU schedule hint, ignored
    ray_tile: Optional[int] = None          # TPU schedule hint, ignored
    # impl='stream': the minimum sphere block (doubled for huge scenes);
    # the lane group was the TPU's culling granularity, a hint here
    stream_block: int = 256
    stream_lane_group: Optional[int] = None
    mxu_dots: bool = False

    def __post_init__(self):
        if self.dtype not in DTYPE_NAMES:
            raise ValueError(f"dtype must be one of {list(DTYPE_NAMES)}, "
                             f"got {self.dtype!r}")
        if self.layout not in LAYOUT_NAMES:
            raise ValueError(f"layout must be one of {list(LAYOUT_NAMES)}")
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {list(IMPLS)}")
        if self.mxu_dots:
            raise ValueError("mxu_dots is a TPU matrix-unit option; the "
                             "CUDA kernel has none")
        if self.dtype == "float64":
            self._check_f64_scope()
        for f in ("width", "height", "samples", "bounces", "threads"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")
        for f in ("chunk_pixels", "pixels_per_lane", "max_samples",
                  "ray_tile"):
            v = getattr(self, f)
            if v is not None and v <= 0:
                raise ValueError(f"{f} must be positive (or None = auto)")
        if self.stream_block <= 0:
            raise ValueError("stream_block must be positive")
        if self.stream_lane_group is not None and self.stream_lane_group < 0:
            raise ValueError("stream_lane_group must be >= 0 (or None = "
                             "auto)")
        if not 0.0 < self.adaptive_tol:
            raise ValueError("adaptive_tol must be positive")
        if self.impl == "adaptive":
            if self.samples % 2 != 0:
                raise ValueError(
                    "impl=adaptive needs even --samples (two half-buffers)")
            if self.effective_max_samples < self.samples:
                raise ValueError("max_samples must be >= samples")
            if self.adaptive_rounds < 1:
                raise ValueError("adaptive_rounds must be >= 1")

    def _check_f64_scope(self):
        """dtype=float64 per impl: ``'oracle'`` (the f64 oracle) takes
        every estimator, ``legacy_sky`` and every layout, as JAX's
        native-f64 oracle does; ``'kernel'`` (the f64 kernel) keeps the
        JAX df64 kernel's scope (``make_df64_renderer``): parity
        estimator, current-bounce sky, layout vmem or hbm; any other impl
        has no f64 path."""
        if self.impl == "oracle":
            return
        if self.impl != "kernel":
            raise ValueError(
                f"dtype=float64 runs on the f64 kernel (impl='kernel') or "
                f"the f64 oracle (impl='oracle'); impl={self.impl} has no "
                f"f64 path")
        if self.legacy_sky or self.rr_start is not None:
            raise ValueError(
                "dtype=float64 with impl='kernel' is the f64 kernel's "
                "precision comparison: parity estimator only (no "
                "legacy_sky / rr_start; impl='oracle' takes both)")
        if self.layout == "packed":
            raise ValueError(
                "dtype=float64 with impl='kernel' has no packed/stream "
                "path; the f64 kernel reads the scene in layout vmem or "
                "hbm (impl='oracle' ignores the layout)")

    @property
    def torch_dtype(self) -> torch.dtype:
        """The render's dtype (JAX's ``jnp_dtype``)."""
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def effective_max_samples(self) -> int:
        return self.max_samples if self.max_samples else 4 * self.samples

    @property
    def effective_chunk_pixels(self) -> int:
        if self.chunk_pixels is not None:
            return self.chunk_pixels
        return max(self.threads * self.threads * 128, 1024)

    def output_filename(self) -> str:
        """Reference file name convention:
        <layout>_<dtype>_scene<id>_<W>x<H>_<S>samples_<B>bounces_
        <threads>threadsPerBlockRow.ppm"""
        return (
            f"{LAYOUT_NAMES[self.layout]}_{DTYPE_NAMES[self.dtype]}"
            f"_scene{self.scene_id}"
            f"_{self.width}x{self.height}"
            f"_{self.samples}samples"
            f"_{self.bounces}bounces"
            f"_{self.threads}threadsPerBlockRow.ppm"
        )
