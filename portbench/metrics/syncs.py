"""Host syncs a request: the rise of the port's ``host_sync`` counter in
the window's requests (each place where the host waits for the card counts
one, inside an ``rt.sync`` span)."""
from portbench import spans


def read(rec):
    return spans.count_per_request(spans.window(rec), "host_sync")
