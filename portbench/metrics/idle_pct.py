"""The device's idle share of the traced window: 1 - (the union of CUDA
activity: kernels, copies, sets) / wall, in percent."""
from portbench import trace


def read(rec):
    return trace.idle_pct(rec.trace)
