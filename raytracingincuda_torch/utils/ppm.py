"""PPM image I/O, byte-compatible with the reference's tooling.

The writer reproduces the reference's P3 output: header
``P3\\n<W> <H>\\n255\\n``, then one ``r g b`` line per pixel, rows top
down, each channel ``int(256 * clamp(x, 0.000, 0.999))``. The reader takes
P3 and P6 with comment lines. Numpy only (the JAX package's
``utils/ppm.py``, unchanged in behavior).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def quantize(img) -> np.ndarray:
    """float (H, W, 3) -> ints by the reference's clamp rule."""
    img = np.asarray(img, np.float64)
    return (256.0 * np.clip(img, 0.000, 0.999)).astype(np.int32)


# Pixels a chunk of the writer (12 bytes each of token buffer)
_WRITE_CHUNK = 1 << 20


# (3, 256, 4) uint8: level v of channel c as its decimal digits and the
# channel's separator (' ', ' ', newline), zero-padded to 4 bytes
_TOKENS = np.array([[np.frombuffer(f"{v}{sep}".encode().ljust(4, b"\0"),
                                   np.uint8) for v in range(256)]
                    for sep in (" ", " ", "\n")])


def write_ppm(path: str, img) -> None:
    """Write a float (H, W, 3) image (already gamma-encoded) as P3: a
    ``r g b`` line a pixel, built from a table of each level's digits in
    chunks of pixels (no text is formatted per pixel)."""
    img = np.asarray(img)
    h, w, _ = img.shape
    flat = img.reshape(-1, 3)
    chan = np.arange(3)
    with open(path, "wb") as f:
        f.write(f"P3\n{w} {h}\n255\n".encode())
        for lo in range(0, flat.shape[0], _WRITE_CHUNK):
            toks = _TOKENS[chan, quantize(flat[lo:lo + _WRITE_CHUNK])]
            f.write(toks[toks != 0].tobytes())


def _read_tokens(data: bytes):
    """Token stream over a PPM header, skipping '#' comments."""
    i, n = 0, len(data)
    while i < n:
        c = data[i:i + 1]
        if c.isspace():
            i += 1
            continue
        if c == b"#":
            while i < n and data[i:i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < n and not data[j:j + 1].isspace():
            j += 1
        yield data[i:j], j
        i = j


def read_ppm(path: str) -> Tuple[np.ndarray, int]:
    """Read P3 or P6. Returns (uint16 array (H, W, 3), maxval)."""
    with open(path, "rb") as f:
        data = f.read()
    toks = _read_tokens(data)
    magic, _ = next(toks)
    if magic not in (b"P3", b"P6"):
        raise ValueError(f"not a P3/P6 PPM: magic={magic!r}")
    w, _ = next(toks)
    h, _ = next(toks)
    maxval, end = next(toks)
    w, h, maxval = int(w), int(h), int(maxval)
    if magic == b"P6":
        if maxval > 255:
            raise NotImplementedError(
                f"P6 with maxval {maxval} > 255 (16-bit) is not supported")
        raw = data[end + 1:end + 1 + w * h * 3]
        if len(raw) != w * h * 3:
            raise ValueError("truncated P6 payload")
        arr = np.frombuffer(raw, np.uint8).astype(np.uint16)
    else:
        lines = [ln.split(b"#", 1)[0] for ln in data[end:].splitlines()]
        arr = np.array(b" ".join(lines).split(), dtype=np.uint16)
        if arr.size != w * h * 3:
            raise ValueError(
                f"P3 payload has {arr.size} values, expected {w * h * 3}")
    return arr.reshape(h, w, 3), maxval


def diff_stats(img, golden) -> dict:
    """Quantized difference of a float image against a quantized one
    (levels): max |d|, share exact, share within 1, mean |d|, mean d."""
    d = quantize(img).astype(np.int64) - np.asarray(golden, np.int64)
    ad = np.abs(d)
    return {"max": int(ad.max()), "exact": float((ad == 0).mean()),
            "within1": float((ad <= 1).mean()), "mad": float(ad.mean()),
            "bias": float(d.mean())}


# The JAX package's golden gate: max |d| <= 1 level and > 99% exact. It
# holds between renders whose arithmetic is the same op for op.
def passes_golden_gate(stats: dict) -> bool:
    return stats["max"] <= 1 and stats["exact"] > 0.99


# Against renders that XLA compiled (jit, or Pallas interpret mode) the
# port's arithmetic differs in the last bit: XLA on a CPU fuses
# multiply-adds (measured: its 3-term dot products differ from unfused f32
# on a third of inputs) and computes rsqrt by a hardware estimate and two
# Newton steps. Now and then such a bit flips a knife-edge hit and sends
# that path elsewhere, moving whole samples of a few pixels. The JAX
# oracle itself, run op by op (``jax.disable_jit()``), fails the golden
# gate against its own 48x30 goldens by as much as the port does (scene 1:
# 0.978 exact, 0.982 within 1 level). This gate bounds the share of such
# flips and the mean error instead (measured on the CPU for the six
# goldens: within1 >= 0.982, mad <= 0.25 level); a systematic error (a
# wrong weight, colour or depth rule) moves most pixels and fails the
# within-1 share.
CROSS_FRAMEWORK_GATE = {"within1": 0.97, "mad": 1.0}


def passes_cross_framework_gate(stats: dict) -> bool:
    g = CROSS_FRAMEWORK_GATE
    return stats["within1"] >= g["within1"] and stats["mad"] <= g["mad"]
