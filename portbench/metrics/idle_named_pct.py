"""Of the device's idle time between the window's device operations, the
share in percent during which a port span below the request's entry span
is open (``spans.idle_named_pct``): how much of the idle the port's own
spans name."""
from portbench import spans


def read(rec):
    if rec.trace is None:
        return None
    return spans.idle_named_pct(spans.window(rec), rec.trace.ops)
