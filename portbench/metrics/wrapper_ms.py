"""Host milliseconds a request in the port's kernel wrappers: the self time
of the ``rt.launch.<kernel>`` spans (their checks, plan and launch, less
the spans inside them)."""
from portbench import spans


def read(rec):
    return spans.self_ms(spans.window(rec),
                         lambda name: name.startswith("rt.launch."))
