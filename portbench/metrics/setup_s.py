"""Process start to the first timed request: imports, the kernel library's
load (its build in a checkout's first run), the scene, the cell's own
preparation and the warm-up."""


def read(rec):
    return rec.setup_s
