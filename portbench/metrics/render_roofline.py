"""The render's needed work at the card's peaks (``portbench/work.py``:
the draws, one sphere test a segment, the shading and the sky; the scan
over candidate spheres is not counted) over the device time of the port's
kernels a render, in percent."""
from portbench import trace, work


def read(rec):
    ms = trace.kernel_ms(rec.trace)
    if ms is None or rec.work is None:
        return None
    return 100.0 * work.least_seconds(rec.work) / (ms / 1e3)
