"""Run configuration: the reference's six CLI flags plus the port's axes.

Field names and ``output_filename()`` are the JAX package's
(``raytracingincuda_tpu/config.py``), so a config and the file it names
carry over unchanged. What this port serves:

  dtype:  float32 only ('float' in the file name)
  layout: vmem ('const': the scene staged in shared memory) |
          hbm ('global': the scene read from device memory) |
          packed ('tex': the texture-path analog, served by the stream
          kernel, as in JAX)
  impl:   kernel (the CUDA regeneration kernel; the JAX 'pallas') |
          stream (the stream kernel: scenes of any size, walked in culled
          sphere blocks of ``stream_block`` rows) |
          oracle (the plain PyTorch tracer)

``threads``, ``chunk_pixels``, ``pixels_per_lane``, ``ray_tile`` and
``stream_lane_group`` shaped the TPU schedule; here they are hints the
CUDA kernels ignore (``chunk_pixels`` still sizes the oracle's pixel
chunks).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .ops.rng import DEFAULT_SEED

DTYPE_NAMES = {"float32": "float"}
LAYOUT_NAMES = {"hbm": "global", "vmem": "const", "packed": "tex"}
IMPLS = ("kernel", "stream", "oracle")
# impls of the JAX package that later slices port (ROADMAP queue 1)
_NOT_YET = {
    "adaptive": "adaptive sampling, ROADMAP queue 1 item 3",
}


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
    # the adaptive fields keep the JAX field names; that impl is not
    # ported yet and raises
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
        if self.dtype == "float64":
            raise NotImplementedError(
                "dtype=float64 is not ported yet (the kernel instantiated "
                "in double, ROADMAP queue 1 item 4)")
        if self.dtype not in DTYPE_NAMES:
            raise ValueError(f"dtype must be one of {list(DTYPE_NAMES)}, "
                             f"got {self.dtype!r}")
        if self.layout not in LAYOUT_NAMES:
            raise ValueError(f"layout must be one of {list(LAYOUT_NAMES)}")
        if self.impl in _NOT_YET:
            raise NotImplementedError(
                f"impl={self.impl} is not ported yet ({_NOT_YET[self.impl]})")
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {list(IMPLS)}")
        if self.mxu_dots:
            raise ValueError("mxu_dots is a TPU matrix-unit option; the "
                             "CUDA kernel has none")
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
