"""The readers of the port's spans and counters (``spans.py`` and
``metrics/<stem>.py``) on a synthetic trace and synthetic records: the
window's selection, self time and time less syncs, the counters a request
and the named share of the idle time."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import spans, trace
from portbench.harness import load_module, metric_file
from portbench.tests.conftest import REPO

US = 1000      # ns


def rec(name, start_us, end_us, parent=-1, counts=None):
    return SimpleNamespace(name=name, start_ns=start_us * US,
                           end_ns=end_us * US, parent=parent, counts=counts)


def records():
    """The untimed first request (0-100 us), then two steps of the window
    (200-1200, 1300-2300); a sync in each, an optimizer with a sync inside,
    a kernel wrapper; an earlier request before them all."""
    out = [rec("rt.train_step", -500, -400, counts={"host_sync": 9}),
           rec("rt.train_step", 0, 100, counts={"host_sync": 2})]
    for t0 in (200, 1300):
        root = len(out)
        out += [rec("rt.train_step", t0, t0 + 1000, counts={"host_sync": 2}),
                rec("rt.sync", t0 + 50, t0 + 100, root,
                    counts={"host_sync": 1}),
                rec("rt.launch.k", t0 + 200, t0 + 300, root),
                rec("rt.optim", t0 + 700, t0 + 900, root,
                    counts={"host_sync": 1})]
        out.append(rec("rt.sync", t0 + 800, t0 + 850, root + 3,
                       counts={"host_sync": 1}))
    return out


def run_record(ops, requests=2):
    t = trace.Trace(window_s=2e-3, busy_s=0.0, requests=requests,
                    ops=[trace.DeviceOp("k", a, b) for a, b in ops],
                    gaps=[], kernels=frozenset())
    return SimpleNamespace(trace=t, work=None)


# device busy 150-250 (before the window), 250-500, 600-800, 1500-2000
OPS = [(150, 250), (250, 500), (600, 800), (1500, 2000)]


def test_window_takes_the_last_requests_after_the_first():
    w = spans.window(run_record(OPS), records())
    assert (w.lo_ns, w.hi_ns, w.requests) == (100 * US, 2300 * US, 2)
    assert w.entry == "rt.train_step"
    assert [w.recs[i].start_ns // US for i in w.inside] == [
        200, 250, 400, 900, 1000, 1300, 1350, 1500, 2000, 2100]
    assert spans.window(run_record(OPS, requests=4), records()) is None
    assert spans.window(run_record([]), records()) is None    # no device op
    assert spans.window(run_record(OPS), []) is None


def test_counters_and_times_a_request():
    w = spans.window(run_record(OPS), records())
    assert spans.count_per_request(w, "host_sync") == 2.0
    assert spans.inside_ms(w, "rt.sync") == pytest.approx(0.1)
    assert spans.self_ms(w, lambda n: n == "rt.optim") == pytest.approx(0.15)
    assert spans.self_ms(w, lambda n: n.startswith("rt.launch.")) == (
        pytest.approx(0.1))
    # a span's time less the syncs at any depth inside it
    assert spans.host_ms(w, "rt.optim") == pytest.approx(0.15)
    assert spans.host_ms(w, "rt.train_step") == pytest.approx(0.9)


def test_idle_named_share():
    """Idle between the window's operations: 500-600 and 800-1500 (800 us);
    named by a span below the entry: 250-300 (busy), 400-500 (busy),
    900-1100 in the first step (200 us of idle), 1350-1400 (50 us)."""
    w = spans.window(run_record(OPS), records())
    assert spans.idle_gaps(run_record(OPS).trace.ops, 100, 2300) == [
        (500, 600), (800, 1500)]
    assert spans.idle_named_pct(w, run_record(OPS).trace.ops) == (
        pytest.approx(100.0 * 250 / 800))


def test_metric_readers(monkeypatch):
    monkeypatch.setattr(spans, "_registry", lambda: SimpleNamespace(
        records=records))
    r = run_record(OPS)
    read = lambda n: load_module(  # noqa: E731
        metric_file(REPO / "portbench", n), "metric").read(r)
    assert read("syncs.train") == 2.0
    assert read("sync_wait_ms.stream") == pytest.approx(0.1)
    assert read("optim_ms.train") == pytest.approx(0.15)
    assert read("wrapper_ms.render") == pytest.approx(0.1)
    assert read("chain_ms.train") == 0.0
    assert read("rebuild_ms.stream") == 0.0
    assert read("idle_named_pct.stream") == pytest.approx(31.25)


def test_readers_without_the_registry(monkeypatch):
    """A port without span records (an older tree) reads nothing."""
    monkeypatch.setattr(spans, "_registry", lambda: None)
    r = run_record(OPS)
    for name in ("syncs.render", "sync_wait_ms.train", "wrapper_ms.stream",
                 "optim_ms.train", "chain_ms.stream", "rebuild_ms.stream",
                 "idle_named_pct.render"):
        assert load_module(metric_file(REPO / "portbench", name),
                           "metric").read(r) is None
