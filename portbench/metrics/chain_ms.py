"""Host milliseconds a request in ``chain_to_params``: the port's
``rt.chain`` spans less the ``rt.sync`` inside them."""
from portbench import spans


def read(rec):
    return spans.host_ms(spans.window(rec), "rt.chain")
