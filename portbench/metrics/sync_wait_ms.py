"""Host milliseconds a request inside the port's ``rt.sync`` spans: the
time the host waited for the card."""
from portbench import spans


def read(rec):
    return spans.inside_ms(spans.window(rec), "rt.sync")
