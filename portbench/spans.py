"""The port's own spans and counters over the traced window.

The port keeps a record of each span it opens while torch's profiler
records (``raytracingincuda_torch/utils/trace.py``): its name, start and
end on the profiler's clock (``time.time_ns()``), its parent and root, and
the counters' rise while it was open. The readers here take the window's
requests from those records: the window's last ``requests`` entry spans
(``ENTRIES``: a render, a train step or a stream step, whichever the
run's roots are), from the end of the entry span before them (the
harness's untimed first request) to the end of the last. A record belongs
to the window if it starts there. Every number is per request. A port
that keeps no records, or too few, reads None, and so does a trace with no
device operation (a run on the CPU): the window is the device trace's.
"""
from __future__ import annotations

import bisect

ENTRIES = ("rt.render", "rt.train_step", "rt.stream_step")


def _registry():
    try:
        from raytracingincuda_torch.utils import trace
    except ImportError:
        return None
    return trace


class Window:
    """The window's records: ``recs`` (all the run's records), ``inside``
    (the indices of those that start in the window), ``entry`` (the entry
    span's name), ``lo_ns`` and ``hi_ns``, ``requests``."""

    def __init__(self, recs, inside, entry, lo_ns, hi_ns, requests):
        self.recs, self.inside, self.entry = recs, inside, entry
        self.lo_ns, self.hi_ns, self.requests = lo_ns, hi_ns, requests

    def children(self) -> dict:
        """Index -> the indices of its children, for the window's records."""
        kids: dict = {}
        for i in self.inside:
            p = self.recs[i].parent
            if p >= 0:
                kids.setdefault(p, []).append(i)
        return kids


def window(rec, records=None):
    """The traced window of run record ``rec`` (``rec.trace.requests``) over
    the port's records (``records``, by default the registry's), or None."""
    t = getattr(rec, "trace", None)
    if t is None or not t.requests or not t.ops:
        return None
    if records is None:
        reg = _registry()
        if reg is None:
            return None
        records = reg.records()
    roots = [r for r in records if r.parent < 0 and r.name in ENTRIES
             and r.end_ns]
    if not roots:
        return None
    entry = roots[-1].name
    roots = [r for r in roots if r.name == entry]
    n = t.requests
    if len(roots) < n + 1:
        return None
    lo, hi = roots[-n - 1].end_ns, roots[-1].end_ns
    inside = [i for i, r in enumerate(records) if lo <= r.start_ns <= hi]
    return Window(records, inside, entry, lo, hi, n)


def count_per_request(w, name: str):
    """Counter ``name``'s rise in the window's roots, a request."""
    if w is None:
        return None
    total = sum((w.recs[i].counts or {}).get(name, 0) for i in w.inside
                if w.recs[i].parent < 0)
    return total / w.requests


def _dur(r) -> int:
    return max(r.end_ns - r.start_ns, 0)


def inside_ms(w, name: str):
    """Milliseconds a request inside spans ``name`` (their whole time)."""
    if w is None:
        return None
    ns = sum(_dur(w.recs[i]) for i in w.inside if w.recs[i].name == name)
    return ns / 1e6 / w.requests


def self_ms(w, match):
    """Milliseconds a request of self time (the span less its children's
    spans) of the spans whose name ``match(name)`` accepts."""
    if w is None:
        return None
    kids = w.children()
    ns = 0
    for i in w.inside:
        r = w.recs[i]
        if match(r.name):
            ns += _dur(r) - sum(_dur(w.recs[k]) for k in kids.get(i, ()))
    return ns / 1e6 / w.requests


def host_ms(w, name: str):
    """Milliseconds a request in spans ``name``, less the ``rt.sync`` spans
    inside them (the time the host waited for the card there)."""
    if w is None:
        return None
    ns = 0
    for i in w.inside:
        r = w.recs[i]
        if r.name == name:
            ns += _dur(r)
        elif r.name == "rt.sync":
            p = r.parent
            while p >= 0 and w.recs[p].name != name:
                p = w.recs[p].parent
            if p >= 0:
                ns -= _dur(r)
    return ns / 1e6 / w.requests


def _merged(intervals) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(ops, lo_us: float, hi_us: float) -> list:
    """The gaps between the device operations' union inside [lo, hi], in
    microseconds: (start, end) pairs, none before the first operation or
    after the last."""
    gaps, reach = [], None
    for o in sorted(ops, key=lambda o: o.start_us):
        if o.end_us <= lo_us or o.start_us >= hi_us:
            continue
        if reach is not None and o.start_us > reach:
            gaps.append((reach, o.start_us))
        reach = o.end_us if reach is None else max(reach, o.end_us)
    return [(max(a, lo_us), min(b, hi_us)) for a, b in gaps
            if min(b, hi_us) > max(a, lo_us)]


def idle_named_pct(w, ops):
    """Of the idle time between the window's device operations, the share
    (in percent) during which a port span other than the entry span is
    open: host time below a request's top that the port's own spans name."""
    if w is None or not ops:
        return None
    gaps = idle_gaps(ops, w.lo_ns / 1e3, w.hi_ns / 1e3)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    named = _merged((w.recs[i].start_ns / 1e3, w.recs[i].end_ns / 1e3)
                    for i in w.inside if w.recs[i].name != w.entry
                    and w.recs[i].end_ns)
    starts = [a for a, _ in named]
    covered = 0.0
    for a, b in gaps:
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(named) and named[k][0] < b:
            covered += max(0.0, min(b, named[k][1]) - max(a, named[k][0]))
            k += 1
    return 100.0 * covered / idle
