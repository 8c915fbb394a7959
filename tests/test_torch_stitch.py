"""Per-rank part files and their stitch (``utils/stitch.py``).

The counterpart of ``tests/test_stitch.py``, case for case, on the port's
own copy of the stitch; and the part files are interchangeable with the
JAX package's in both directions.
"""
import numpy as np
import pytest

from raytracingincuda_torch.utils.ppm import write_ppm
from raytracingincuda_torch.utils.stitch import (main as stitch_main,
                                                 save_image_part,
                                                 stitch_parts)


def _img(h=24, w=40):
    rng = np.random.default_rng(3)
    return rng.uniform(0, 1, (h, w, 3)).astype(np.float32)


def test_stitch_roundtrip(tmp_path):
    img = _img()
    h, w, _ = img.shape
    flat = img.reshape(-1, 3)
    # uneven, non-row-aligned split across 3 ranks
    cuts = [0, 333, 700, h * w]
    paths = []
    for k in range(3):
        p = str(tmp_path / f"out.part{k}.npz")
        save_image_part(p, flat[cuts[k]:cuts[k + 1]], cuts[k], (h, w))
        paths.append(p)
    np.testing.assert_array_equal(stitch_parts(paths), img)


def test_stitch_cli_writes_identical_ppm(tmp_path):
    img = _img()
    h, w, _ = img.shape
    flat = img.reshape(-1, 3)
    parts = []
    half = (h * w) // 2
    for k, (a, b) in enumerate([(0, half), (half, h * w)]):
        p = str(tmp_path / f"x.part{k}.npz")
        save_image_part(p, flat[a:b], a, (h, w))
        parts.append(p)
    out_ppm = str(tmp_path / "stitched.ppm")
    ref_ppm = str(tmp_path / "direct.ppm")
    stitch_main(parts + ["-o", out_ppm])
    write_ppm(ref_ppm, img.astype(np.float64))
    assert open(out_ppm).read() == open(ref_ppm).read()


def test_stitch_detects_gap(tmp_path):
    img = _img()
    h, w, _ = img.shape
    p = str(tmp_path / "only.npz")
    save_image_part(p, img.reshape(-1, 3)[: h * w - 5], 0, (h, w))
    with pytest.raises(ValueError, match="uncovered"):
        stitch_parts([p])


def test_stitch_trims_padding(tmp_path):
    """Trailing padding beyond the image is trimmed, as a rank's padded
    lanes produce it."""
    img = _img()
    h, w, _ = img.shape
    padded = np.concatenate([img.reshape(-1, 3), np.zeros((64, 3),
                                                          np.float32)])
    p = str(tmp_path / "pad.npz")
    save_image_part(p, padded, 0, (h, w))
    np.testing.assert_array_equal(stitch_parts([p]), img)


@pytest.mark.parametrize("case", [
    dict(shape=(5, 40), offset=0, values=np.ones((3, 3)), match="image shape"),
    dict(shape=(24, 40), offset=-3, values=np.ones((3, 3)),
         match="negative"),
    dict(shape=(24, 40), offset=0, values=np.zeros((3, 3)),
         match="disagrees"),
])
def test_stitch_rejects(tmp_path, case):
    """A part of another image, a negative offset, and an overlap whose
    values differ are refused."""
    img = _img()
    h, w, _ = img.shape
    first = str(tmp_path / "a.npz")
    save_image_part(first, img.reshape(-1, 3), 0, (h, w))
    second = str(tmp_path / "b.npz")
    save_image_part(second, case["values"], case["offset"], case["shape"])
    with pytest.raises(ValueError, match=case["match"]):
        stitch_parts([first, second])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_parts_interchange_with_jax(tmp_path, direction):
    """Parts the port writes stitch in the JAX package, and the other way
    round, to the same image and the same PPM bytes."""
    from raytracingincuda_tpu.utils import stitch as jstitch

    img = _img()
    h, w, _ = img.shape
    flat = img.reshape(-1, 3)
    save, stitch = ((save_image_part, jstitch.stitch_parts)
                    if direction == "port_to_jax"
                    else (jstitch.save_image_part, stitch_parts))
    paths = []
    for k, (a, b) in enumerate([(0, 517), (517, h * w)]):
        p = str(tmp_path / f"p{k}.npz")
        save(p, flat[a:b], a, (h, w))
        paths.append(p)
    np.testing.assert_array_equal(stitch(paths), img)
    write_ppm(str(tmp_path / "a.ppm"), stitch(paths).astype(np.float64))
    write_ppm(str(tmp_path / "b.ppm"), img.astype(np.float64))
    assert ((tmp_path / "a.ppm").read_bytes()
            == (tmp_path / "b.ppm").read_bytes())
