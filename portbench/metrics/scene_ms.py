"""Host milliseconds a request in a streamed step's passes over every
slot: the stream rebuild (``rt.stream.rebuild``), the cotangents' scatter
back to slots (``rt.stream.to_slots``), the scene's part of
``chain_to_params`` (``rt.chain.scene``) and the optimizer
(``rt.optim``), each less the ``rt.sync`` inside it. None where the port
keeps no ``rt.stream.to_slots`` span (an older tree)."""
from portbench import spans

NAMES = ("rt.stream.rebuild", "rt.stream.to_slots", "rt.chain.scene",
         "rt.optim")


def read(rec):
    w = spans.window(rec)
    if w is None or not any(w.recs[i].name == "rt.stream.to_slots"
                            for i in w.inside):
        return None
    return sum(spans.host_ms(w, name) for name in NAMES)
