"""The port's spans and counters: one registry, on torch's profiler clock.

Counters are always on. ``count(name, n)`` adds ``n`` to a dict that
``counts()`` reads: the kernel launches (``launch.<kernel>``, the group
table's ``launch.group_table`` and the stream walk's tables'
``launch.walk_tables`` among them), the closest-hit scan each
scanning launch ran (``scan.two_level``, ``scan.one_level``;
``ops/group_scan.py``), a streamed scene's size (``stream.rows``, the
matrix rows ``build_stream_arrays`` writes; ``stream.blocks``, the bounds
rows each walk launch of the stream kernels reads; ``stream.groups``, the
group-table rows the table launch before it builds, bounds rows times
groups a block), the places
where the host waits for the card (``host_sync``) and the collectives
(``all_reduce.calls``, ``all_reduce.numel``).

Spans are on while a torch profiler records
(``torch.autograd._profiler_enabled()``) or inside ``recording()``. A span
then does two things: it opens a ``torch.profiler.record_function`` range
of its name, so the span sits in the profiler's trace among the operators
it runs (and in ``export_chrome_trace`` above the device rows), and it
keeps a ``Record``: its name, its start and end stamped with
``time.time_ns()`` (the clock the profiler's events report), the index of
its parent and of its root (the outermost span open, a request) in
``records()``, and what each counter rose by while it was open. A counter
that rises while spans are on is charged to every span open, its root
among them. Records are kept up to ``CAP``; later ones are dropped and
counted (``dropped()``). While spans are off, ``span`` returns one shared
context that does nothing: no record, no profiler range, nothing on the
device.

Names: ``rt.<layer>`` for the port's host layers (``rt.render``,
``rt.train_step``, ``rt.stream_step`` and ``rt.make_renderer`` at the
entry; ``rt.lanes``, ``rt.stream.rebuild``, ``rt.stream.to_slots``,
``rt.chain``, ``rt.optim``, ``rt.records``, ``rt.finalize``,
``rt.all_reduce`` below them),
``rt.launch.<kernel>`` around a kernel wrapper's checks, plan and launch,
and ``rt.sync`` around a place where the host waits for the card
(``sync()``).
"""
from __future__ import annotations

import functools
import time
from contextlib import contextmanager, nullcontext

import torch

CAP = 1 << 20

_counts: dict = {}
_records: list = []
_stack: list = []          # the open spans' records, innermost last
_dropped = 0
_recording = 0
_OFF = nullcontext()
_profiling = torch.autograd._profiler_enabled


class Record:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns()``;
    ``end_ns`` 0 while open), ``parent`` and ``root`` (indices in
    ``records()``; ``parent`` -1 and ``root`` its own index for a root, -1
    where that record was dropped) and ``counts``, the counters' rise while
    it was open (None if none rose)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "root", "counts",
                 "index")

    def __repr__(self):
        return (f"Record({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"parent={self.parent}, root={self.root}, "
                f"counts={self.counts})")


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str):
        global _dropped
        rec = self.rec = Record()
        rec.name, rec.end_ns, rec.counts = name, 0, None
        if len(_records) < CAP:
            rec.index = len(_records)
            _records.append(rec)
        else:
            rec.index = -1
            _dropped += 1

    def __enter__(self):
        rec = self.rec
        self.rf = torch.profiler.record_function(rec.name)
        self.rf.__enter__()
        if _stack:
            rec.parent, rec.root = _stack[-1].index, _stack[0].index
        else:
            rec.parent, rec.root = -1, rec.index
        _stack.append(rec)
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.time_ns()
        if _stack and _stack[-1] is rec:
            _stack.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """``with span(name): ...``: a span while spans are on, else nothing."""
    if _recording or _profiling():
        return _Span(name)
    return _OFF


def spanned(name: str):
    """A decorator: the function's every call in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, and to every open span's record."""
    _counts[name] = _counts.get(name, 0) + n
    for rec in _stack:
        c = rec.counts
        if c is None:
            c = rec.counts = {}
        c[name] = c.get(name, 0) + n


def sync():
    """``with sync(): <a read the host waits on>``: counts ``host_sync``
    and spans ``rt.sync``. For the places where the host waits for the
    card: a device tensor read as a number or copied to or from the host,
    or an op whose output's shape depends on the data."""
    count("host_sync")
    return span("rt.sync")


@contextmanager
def recording():
    """Spans on inside, whether a profiler records or not."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def counts() -> dict:
    """A copy of the counters."""
    return dict(_counts)


def records() -> list:
    """The records kept since the last ``reset()``, in the order the spans
    opened (a copy of the list; the records themselves are shared)."""
    return list(_records)


def dropped() -> int:
    """Records not kept since the last ``reset()``: past ``CAP``."""
    return _dropped


def innermost():
    """The name of the innermost open span, or None."""
    return _stack[-1].name if _stack else None


def reset() -> None:
    """Clear the counters and the records (spans still open stay out of
    the new ones)."""
    global _dropped
    _counts.clear()
    _records.clear()
    _stack.clear()
    _dropped = 0
