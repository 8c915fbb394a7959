"""The double render's needed work at the card's peaks
(``portbench/work_f64.py``: the draws, one sphere test a segment, the
shading and the sky in FP64; the scan over candidate spheres is not
counted) over the device time of the port's kernels a render, in
percent."""
from portbench import trace, work_f64


def read(rec):
    ms = trace.kernel_ms(rec.trace)
    if ms is None or rec.work is None:
        return None
    return 100.0 * work_f64.least_seconds(rec.work) / (ms / 1e3)
