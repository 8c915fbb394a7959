"""Host milliseconds a request in ``build_stream_arrays``, the stream
matrix and bounds rebuilt each step: the port's ``rt.stream.rebuild``
spans less the ``rt.sync`` inside them."""
from portbench import spans


def read(rec):
    return spans.host_ms(spans.window(rec), "rt.stream.rebuild")
