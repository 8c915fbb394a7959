"""The metric arithmetic: the window rate, the 90th percentile over every
request, the idle union and the port's kernels on synthetic events, and
the needed-work count against a hand count of one segment."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import stats, trace, work
from portbench.harness import load_module, metric_file
from portbench.tests.conftest import REPO


class Ev:
    def __init__(self, name, start_us, end_us, cuda=False):
        self._n, self._s, self._e, self._c = name, start_us, end_us, cuda

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def start_ns(self):
        return int(self._s * 1e3)

    def duration_ns(self):
        return int((self._e - self._s) * 1e3)

    def activity_type(self):
        if "portbench" in self._n:
            return "gpu_user_annotation" if self._c else "user_annotation"
        if not self._c:
            return "cpu_op"
        return "gpu_memcpy" if self._n.startswith("Memcpy") else "kernel"


def test_window_rate_and_percentile():
    assert stats.window_ms(2.0, 8) == 250.0
    assert stats.window_ms(2.0, 0) is None
    lat = [0.010] * 9 + [0.100]          # every request counts, the slow too
    assert stats.percentile_ms(lat, 90) == pytest.approx(10.0)
    assert stats.percentile_ms(lat + [0.2], 90) == pytest.approx(100.0)
    assert stats.percentile_ms([], 90) is None


def _synthetic(Ev=Ev):
    evs = [Ev(trace.WINDOW_MARK, 0, 1000),
           Ev(trace.REQUEST_MARK, 0, 500), Ev(trace.REQUEST_MARK, 500, 1000),
           Ev("aten::copy_", 100, 300), Ev("cudaStreamSynchronize", 600, 850),
           Ev("void regen_kernel(int const*)", 0, 100, cuda=True),
           Ev("(anonymous namespace)::reverse_kernel<0, 64>(float*)", 50, 200,
              cuda=True),
           Ev("at::native::vectorized_elementwise_kernel<4>()", 400, 600,
              cuda=True),
           Ev("Memcpy DtoH", 900, 1200, cuda=True),
           # the device-side shadow of a host annotation is no device op
           Ev(trace.REQUEST_MARK, 0, 1000, cuda=True)]
    return trace.reduce(evs, frozenset({"regen_kernel", "reverse_kernel"}))


class OldEv(Ev):
    """An event of a profiler that gives no activity type."""
    activity_type = property(lambda self: (_ for _ in ()).throw(
        AttributeError("activity_type")))


@pytest.mark.parametrize("kind", [Ev, OldEv])
def test_idle_union_gaps_and_kernels(kind):
    t = _synthetic(kind)
    assert t.window_s == pytest.approx(1e-3)
    # union: [0, 200] + [400, 600] + [900, 1000] (clipped at the window)
    assert t.busy_s == pytest.approx(500e-6)
    assert t.requests == 2
    gaps = dict(trace.top(t.gaps))
    assert gaps["aten::copy_"] == pytest.approx(200e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(300e-6)
    rec = SimpleNamespace(trace=t, work=None)
    read = lambda n: load_module(  # noqa: E731
        metric_file(REPO / "portbench", n), "metric").read(rec)
    assert read("idle_pct.train") == pytest.approx(50.0)
    assert read("kernel_ms.render") == pytest.approx(0.25 / 2)
    assert read("launches.train") == pytest.approx(2.0)
    assert read("render_roofline") is None          # no work counted
    rec.work = {"fp32_ops": 0.0, "int32_ops": 33.5e12 * 1e-4 * 0.5,
                "bytes": 0.0}
    assert read("render_roofline") == pytest.approx(40.0)
    assert read("idle_pct.render") == read("idle_pct.train")


def test_no_device_ops_reads_nothing():
    t = trace.reduce([Ev(trace.WINDOW_MARK, 0, 10),
                      Ev(trace.REQUEST_MARK, 0, 10)], frozenset())
    rec = SimpleNamespace(trace=t, work={"fp32_ops": 1.0, "int32_ops": 1.0,
                                         "bytes": 1.0})
    for name in ("idle_pct.render", "kernel_ms.train", "render_roofline",
                 "launches.train"):
        assert load_module(metric_file(REPO / "portbench", name),
                           "metric").read(rec) is None


def test_kernel_names():
    assert trace.kernel_base("void regen_kernel(int const*, float)") == \
        "regen_kernel"
    assert trace.kernel_base(
        "void (anonymous namespace)::reverse_kernel<true, 64>(float*)") == \
        "reverse_kernel"
    assert trace._mangled_base("_ZN12_GLOBAL__N_112regen_kernelEPKi") == \
        "regen_kernel"
    assert trace._mangled_base("_Z14reverse_kernelILb1ELi64EEvPf") == \
        "reverse_kernel"
    assert trace._mangled_base("regen_render") == "regen_render"


def test_elf_symbols_of_a_loaded_library():
    import torch

    lib = next(p for p in (torch.__path__[0] + "/lib/libc10.so",)
               if __import__("os").path.exists(p))
    names = trace.elf_functions(__import__("pathlib").Path(lib))
    assert names and all(isinstance(n, str) for n in names)


def test_threefry_block_hand_count():
    # two key adds; 20 rounds of add, rotate (two shifts, an or), xor;
    # five key injections of two adds
    assert work.threefry_ops() == 2 + 20 * 5 + 5 * 2


def test_needed_work_of_one_segment_by_hand():
    """One sample whose camera ray hits a sphere, scatters, and then
    misses: 2 + 1 Threefry blocks, one test, one shading, one scatter, one
    sky."""
    one = {"samples": 1, "hits": 1, "misses": 1, "rr_draws": 0}
    got = work.needed(one, pixels=1, slots=512)
    assert got["int32_ops"] == 3 * 112
    assert got["fp32_ops"] == 37 + (18 + 24 + 19) + 27 + 6
    assert got["bytes"] == 512 * 11 * 4 + 3 * 4
    rr = work.needed(dict(one, rr_draws=1), pixels=1, slots=512)
    assert rr["int32_ops"] - got["int32_ops"] == 112
    assert rr["fp32_ops"] - got["fp32_ops"] == 9
    assert work.least_seconds(got) == pytest.approx(
        max(got["fp32_ops"] / 67e12, 336 / 33.5e12, got["bytes"] / 3.35e12))
