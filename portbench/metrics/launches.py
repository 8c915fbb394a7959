"""Device operations (kernels, copies, sets) the profiler saw a step."""
from portbench import trace


def read(rec):
    return trace.launches(rec.trace)
