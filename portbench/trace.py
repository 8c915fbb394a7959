"""The traced window: device activity, idle gaps and the port's own kernels.

``Tracer`` runs the window's requests under ``torch.profiler`` (CPU and
CUDA activities) and reduces the raw events to what the per-layer
metrics read (``Trace``): the window's wall time between the benchmark's
own markers, the union of device activity inside it (kernels, copies and
sets), each device operation with its time, and the host operation that
was running in each gap of the device's work. ``library_kernels`` reads
the names of the kernels that the port's own built library defines from
its symbols, so a renamed or added kernel counts without an edit here.
"""
from __future__ import annotations

import bisect
import re
import struct
from pathlib import Path
from typing import NamedTuple

WINDOW_MARK = "portbench.window"
REQUEST_MARK = "portbench.request"
_GAP_SCAN = 256


class DeviceOp(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Trace(NamedTuple):
    window_s: float        # wall time of the traced window
    busy_s: float          # union of device activity inside it
    requests: int          # requests the window holds
    ops: list              # DeviceOp inside the window
    gaps: list             # (host op running, seconds) per idle gap
    kernels: frozenset     # kernel names the port's library defines


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _on_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def _device_op(ev, host_names: set) -> bool:
    """A kernel, copy or set on the device; not the device-side shadow of
    a host annotation (``record_function``), which spans its whole range.
    Where the profiler gives no activity type, a shadow is told by its
    name, which the host side carries too."""
    if not _on_device(ev):
        return False
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type()).split(".")[-1] in DEVICE_ACTIVITIES
    return ev.name() not in host_names


def reduce(events, kernels: frozenset) -> Trace:
    """Raw profiler events -> ``Trace`` over the window marker's span.
    ``events``: objects with ``name()``, ``device_type()``, ``start_ns()``
    and ``duration_ns()`` (the profiler's kineto events)."""
    events = list(events)
    host_names = {ev.name() for ev in events if not _on_device(ev)}
    cpu, dev, window, requests = [], [], None, 0
    for ev in events:
        start = ev.start_ns() / 1e3
        end = start + ev.duration_ns() / 1e3
        name = ev.name()
        if _device_op(ev, host_names):
            dev.append(DeviceOp(name, start, end))
        elif _on_device(ev):
            continue
        elif name == WINDOW_MARK:
            window = (start, end)
        elif name == REQUEST_MARK:
            requests += 1
        elif not name.startswith("portbench."):
            cpu.append((start, end, name))
    if window is None:
        raise RuntimeError("the trace holds no window marker")
    lo, hi = window
    ops = sorted((DeviceOp(o.name, max(o.start_us, lo), min(o.end_us, hi))
                  for o in dev if o.end_us > lo and o.start_us < hi),
                 key=lambda o: o.start_us)
    busy, reach, gaps = 0.0, lo, []
    cpu.sort()
    starts = [c[0] for c in cpu]
    for o in ops:
        if o.start_us > reach:
            gaps.append(_gap(reach, o.start_us, cpu, starts))
        if o.end_us > reach:
            busy += o.end_us - max(o.start_us, reach)
            reach = o.end_us
    if hi > reach:
        gaps.append(_gap(reach, hi, cpu, starts))
    return Trace((hi - lo) / 1e6, busy / 1e6, requests, ops, gaps, kernels)


def _gap(a: float, b: float, cpu: list, starts: list) -> tuple:
    """(the innermost host op running at the gap's middle, seconds)."""
    mid = 0.5 * (a + b)
    k = bisect.bisect_right(starts, mid)
    best = None
    for start, end, name in reversed(cpu[max(0, k - _GAP_SCAN):k]):
        if end >= mid:
            best = name
            break
    return (best or "host: no profiled op", (b - a) / 1e6)


def top(pairs, n: int = 10) -> list:
    """The ``n`` names with the most seconds, summed by name."""
    by: dict = {}
    for name, s in pairs:
        by[name] = by.get(name, 0.0) + s
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_pct(t):
    """The device's idle share of the traced window, in percent: 1 -
    (the union of device activity) / wall."""
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernel_ms(t):
    """Device milliseconds a request of the kernels the port's own built
    library defines."""
    if t is None or not t.requests or not t.kernels:
        return None
    us = sum(o.end_us - o.start_us for o in t.ops
             if kernel_base(o.name) in t.kernels)
    return us / 1e3 / t.requests if us > 0 else None


def launches(t):
    """Device operations (kernels, copies, sets) a request."""
    if t is None or not t.requests or not t.ops:
        return None
    return len(t.ops) / t.requests


def kernel_base(name: str) -> str:
    """A profiler kernel name's function: no return type, namespace,
    template arguments or parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void\s+", "", name.strip())
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).split("::")[-1].strip()


def _mangled_base(sym: str) -> str:
    """The function identifier of an Itanium-mangled (or plain) name."""
    if not sym.startswith("_Z"):
        return sym
    s, i, names = sym, 2, []
    nested = s[i:i + 1] == "N"
    i += nested
    while i < len(s) and s[i].isdigit():
        j = i
        while j < len(s) and s[j].isdigit():
            j += 1
        n = int(s[i:j])
        names.append(s[j:j + n])
        i = j + n
        if not nested:
            break
    return names[-1] if names else sym


def elf_functions(path: Path) -> set:
    """Identifiers of the functions an ELF64 shared object defines (its
    .symtab and .dynsym)."""
    data = path.read_bytes()
    if data[:4] != b"\x7fELF" or data[4] != 2:
        return set()
    shoff, = struct.unpack_from("<Q", data, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", data, 0x3A)
    secs = [struct.unpack_from("<IIQQQQIIQQ", data, shoff + k * shentsize)
            for k in range(shnum)]
    out = set()
    for sec in secs:
        if sec[1] not in (2, 11):          # SHT_SYMTAB, SHT_DYNSYM
            continue
        strtab = secs[sec[6]]
        off, size, ent = sec[4], sec[5], sec[9] or 24
        for k in range(size // ent):
            name_off, info, _, shndx, _, _ = struct.unpack_from(
                "<IBBHQQ", data, off + k * ent)
            if info & 0xF != 2 or shndx == 0:   # defined functions only
                continue
            a = strtab[4] + name_off
            b = data.index(b"\0", a)
            out.add(_mangled_base(data[a:b].decode("ascii", "replace")))
    return out


def library_kernels(package_dir: Path) -> frozenset:
    """Function names of the shared objects this process has loaded from
    ``package_dir`` (the port's built kernel library)."""
    names: set = set()
    package_dir = package_dir.resolve()
    seen = set()
    try:
        maps = Path("/proc/self/maps").read_text().splitlines()
    except OSError:
        return frozenset()
    for line in maps:
        parts = line.split(None, 5)
        if len(parts) < 6 or not parts[5].endswith(".so"):
            continue
        p = Path(parts[5])
        if p in seen or package_dir not in p.parents:
            continue
        seen.add(p)
        names |= elf_functions(p)
    return frozenset(names)


class Tracer:
    """``with Tracer() as t: <the window, inside WINDOW_MARK>`` then
    ``t.result(kernels)``."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def result(self, kernels: frozenset) -> Trace:
        return reduce(self.prof.profiler.kineto_results.events(), kernels)
