"""Device milliseconds a request of the kernels that the port's own built
library defines (names read from its symbols), over the traced requests."""
from portbench import trace


def read(rec):
    return trace.kernel_ms(rec.trace)
