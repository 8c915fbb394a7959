"""Host milliseconds a request in the optimizer's apply: the port's
``rt.optim`` spans less the ``rt.sync`` inside them."""
from portbench import spans


def read(rec):
    return spans.host_ms(spans.window(rec), "rt.optim")
