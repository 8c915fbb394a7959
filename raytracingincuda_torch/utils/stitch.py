"""Multi-process image assembly: per-rank part files and their stitch.

The port's copy of ``raytracingincuda_tpu/utils/stitch.py`` (numpy only),
with the same file format, so part files are interchangeable with the JAX
package's in both directions. Each rank of a sharded render owns a
contiguous slice of the flat pixel axis (``parallel/mesh.py``; slice
boundaries need not be row-aligned). Rather than gathering the image to
write a file, each rank may save its slice with its offset, and the
stitch assembles the P3 PPM, byte-identical to a single-process render's
(values are stored as float32, as the JAX package stores them).

Usage (per rank):
    save_image_part(f"out.part{rank}.npz", local_img_flat, offset, (H, W))
then anywhere with all parts visible:
    python -m raytracingincuda_torch.utils.stitch out.part*.npz -o out.ppm
"""
from __future__ import annotations

import argparse
import glob as _glob
from typing import Sequence, Tuple

import numpy as np

from .ppm import write_ppm


def save_image_part(
    path: str,
    values: np.ndarray,
    offset: int,
    image_shape: Tuple[int, int],
) -> None:
    """Persist one rank's flat pixel slice.

    values: (n, 3) float radiance (already scaled and gamma'd like the
    full image); offset: global flat pixel index of values[0];
    image_shape: (H, W) of the final image.
    """
    values = np.asarray(values, np.float32).reshape(-1, 3)
    np.savez(
        path,
        values=values,
        offset=np.int64(offset),
        height=np.int64(image_shape[0]),
        width=np.int64(image_shape[1]),
    )


def stitch_parts(paths: Sequence[str]) -> np.ndarray:
    """Assemble saved parts into the full (H, W, 3) image.

    Validates consistent image shapes, full coverage, and no overlapping
    disagreement (parts may overlap only with identical values, such as
    replicated padding)."""
    if not paths:
        raise ValueError("no parts given")
    h = w = None
    img = None
    filled = None
    for p in sorted(paths):
        z = np.load(p)
        ph, pw = int(z["height"]), int(z["width"])
        if h is None:
            h, w = ph, pw
            img = np.zeros((h * w, 3), np.float32)
            filled = np.zeros((h * w,), bool)
        elif (ph, pw) != (h, w):
            raise ValueError(f"{p}: image shape {(ph, pw)} != {(h, w)}")
        vals = z["values"]
        off = int(z["offset"])
        n = vals.shape[0]
        if off < 0:
            # a negative offset would resolve as a wrap-around numpy slice
            # and misplace pixels
            raise ValueError(f"{p}: negative pixel offset {off}")
        if off + n > h * w:
            # trailing padding beyond the image is legal; trim
            n = max(0, min(n, h * w - off))
            vals = vals[:n]
        overlap = filled[off:off + n]
        if overlap.any() and not np.array_equal(
                img[off:off + n][overlap], vals[overlap]):
            raise ValueError(f"{p}: overlapping region disagrees")
        img[off:off + n] = vals
        filled[off:off + n] = True
    if not filled.all():
        missing = int((~filled).sum())
        raise ValueError(f"stitch incomplete: {missing} pixels uncovered")
    return img.reshape(h, w, 3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ppm_stitch",
        description="Assemble per-rank image parts into one P3 PPM",
    )
    ap.add_argument("parts", nargs="+",
                    help="part files (globs ok): out.part*.npz")
    ap.add_argument("-o", "--out", required=True, help="output .ppm")
    args = ap.parse_args(argv)
    paths = []
    for pat in args.parts:
        hits = _glob.glob(pat)
        paths.extend(hits if hits else [pat])
    img = stitch_parts(paths)
    write_ppm(args.out, img.astype(np.float64))
    print(f"stitched {len(paths)} parts -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
