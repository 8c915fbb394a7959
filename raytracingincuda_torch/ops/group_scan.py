"""The two-level closest-hit scan: its group table and its plain models.

Kernel 1, kernel 2's park render and kernel 7 find the closest hit with
``csrc/path_common.cuh``'s ``ScanHit`` and a group table, and kernel 6
with the same table in double (``csrc/f64_render.cu``); the reverse
(kernels 2 and 3) scans in one level. With a table the scan tests the
large slots, then walks groups of ``GROUP`` small slots, each behind a
conservative bound sphere, and a warp tests a group's members only where
some lane of it could improve its best hit there. The headers of
``path_common.cuh`` and ``f64_render.cu`` argue why the winner is the
brute-force scan's bit for bit; ``model_scan`` here is that scan with the
kernel's arithmetic, its warps' votes and its counts, for the tests and the
count modes' plain versions: in f32 on a table as it is built, in double
(kernel 6's) on ``double_table``'s.

  * ``group_table`` builds the table for a CUDA launch with the one-block
    kernel of ``csrc/group_table.cu`` (``group_table_kernel``, counted
    ``launch.group_table``), or returns None where the scan stays
    one-level: layout ``'hbm'``, fewer than ``2 * GROUP`` slots, or more
    than ``MAX_SLOTS``;
  * ``group_table_reference`` is that kernel's plain twin, word for word,
    on the CPU (the tests, the count mode's plain version);
  * ``count_path`` counts a scanning launch as ``scan.two_level`` or
    ``scan.one_level`` (``utils/trace.py``);
  * ``unpack`` reads a table's header, entries, slots and bounds, and
    ``double_table`` gives it kernel 6's double entries.

The group size and the other constants are read from ``path_common.cuh``
and ``group_table.cu``, their one place in the source.
"""
from __future__ import annotations

import ctypes
import re
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import trace
from . import _build, f32math
from . import kernel_io as kio
from .kernel_io import WARP


def constants(source: str) -> dict:
    """The ``constexpr int|float kName = value;`` lines of the kernel
    source ``csrc/<source>``."""
    out = {}
    for kind, name, value in re.findall(
            r"^constexpr (int|float) (k\w+) = ([0-9a-fA-Fxp.+-]+)f?;",
            (_build.CSRC_DIR / source).read_text(), flags=re.M):
        v = value.rstrip("f")
        out[name] = int(v) if kind == "int" else float(
            np.float32(float.fromhex(v) if v.startswith("0x") else float(v)))
    return out


_C = constants("path_common.cuh")
GROUP = _C["kGroup"]
LARGE_SCALE = _C["kLargeScale"]
PAD = _C["kPad"]
SLACK = _C["kSlack"]
SAFE = _C["kSafe"]
HEAD = _C["kTableHead"]
MAX_SLOTS = constants("group_table.cu")["kMaxSlots"]
T_MIN, T_MISS = _C["kTMin"], _C["kTMiss"]
_NAN_BITS = 0x7FFFFFFF


def entries(n: int) -> int:
    """Scan entries a table of ``n`` slots holds (path_common.cuh)."""
    return (n + GROUP + 5) & ~3


def bounds(n: int) -> int:
    return (n + GROUP - 1) // GROUP


def table_words(n: int) -> int:
    return HEAD + 4 * entries(n) + 4 * bounds(n) + entries(n)


def uses_groups(n: int, layout: str) -> bool:
    """Whether a launch over ``n`` slots scans in two levels."""
    return layout == "vmem" and 2 * GROUP <= n <= MAX_SLOTS


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _morton(q: torch.Tensor) -> torch.Tensor:
    """(N, 3) 10-bit coordinates -> (N,) int64 Morton codes, bit 3b + a
    holding bit b of axis a, as ``stream_kernel``'s Morton sort orders."""
    out = torch.zeros(q.shape[0], dtype=torch.int64)
    for b in range(10):
        for a in range(3):
            out |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return out


def _orderable(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 keys that sort as the floats do (group_table.cu)."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def group_table_reference(scene_mat: torch.Tensor,
                          cam_row: torch.Tensor) -> torch.Tensor:
    """The plain twin of ``csrc/group_table.cu``: the (table_words(n),)
    int32 table of an (N, 16) scene matrix and a (1, 24) camera row, on
    the matrix's device, computed on the CPU in f32 with the kernel's
    association."""
    n = scene_mat.shape[0]
    if not 2 * GROUP <= n <= MAX_SLOTS:
        raise ValueError(f"a group table takes {2 * GROUP} to {MAX_SLOTS} "
                         f"slots, got {n}")
    m = scene_mat.detach().to("cpu", torch.float32)
    c, r = m[:, 0:3], m[:, 3]
    ar = r.abs()
    act = m[:, 10] > 0.5
    safe = ((c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]) + c[:, 2] * c[:, 2]
            + r * r) <= SAFE
    ok = act & safe
    radii = ar[ok].sort().values
    thr = (_f32(LARGE_SCALE) * radii[(radii.numel() - 1) // 2]
           if radii.numel() else _f32(0.0))
    small = ok & ~(ar > thr)
    large = act & ~small
    big = _f32(T_MISS)
    lo = torch.where(small[:, None], c, big).amin(0) + 0.0
    hi = torch.where(small[:, None], c, -big).amax(0) + 0.0
    span = torch.clamp_min((hi - lo).amax(), 1e-9)
    q = ((c - lo) / span * 1023.0).clamp(0.0, 1023.0).to(torch.int64)
    slots = torch.arange(n, dtype=torch.int64)
    large_ids = slots[large]
    small_ids = slots[small]
    small_ids = small_ids[torch.argsort((_morton(q[small]) << 32) | small_ids)]
    n_large, n_small = large_ids.numel(), small_ids.numel()
    ng = -(-n_small // GROUP)

    # (ng, GROUP) members, -1 past the last
    mem = torch.full((ng * GROUP,), -1, dtype=torch.int64)
    mem[:n_small] = small_ids
    mem = mem.view(ng, GROUP)
    have = mem >= 0
    mc = c[mem.clamp_min(0)]                                  # (ng, G, 3)
    gl = torch.where(have[..., None], mc, big).amin(1)
    gh = torch.where(have[..., None], mc, -big).amax(1)
    ctr = (gl + gh) * 0.5 + 0.0                               # (ng, 3)
    e = mc - ctr[:, None, :]
    dist = f32math.sqrt((e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1])
                        + e[..., 2] * e[..., 2]) + ar[mem.clamp_min(0)]
    rad = torch.where(have, dist, _f32(0.0)).amax(1).clamp_min(0.0)
    cn = f32math.sqrt((ctr[:, 0] * ctr[:, 0] + ctr[:, 1] * ctr[:, 1])
                      + ctr[:, 2] * ctr[:, 2])
    rw = (rad + _f32(PAD) * (cn + rad)) + _f32(SLACK)
    eye = cam_row.detach().to("cpu", torch.float32)[0, 9:12]
    ev = ctr - eye
    key = f32math.sqrt((ev[:, 0] * ev[:, 0] + ev[:, 1] * ev[:, 1])
                       + ev[:, 2] * ev[:, 2]) - rw
    order = torch.argsort((_orderable(key) << 16)
                          | torch.arange(ng, dtype=torch.int64))

    ne, nb = entries(n), bounds(n)
    nlp = (n_large + 3) & ~3
    slot = torch.full((ne,), -1, dtype=torch.int64)
    slot[:n_large] = large_ids
    slot[nlp:nlp + ng * GROUP] = mem[order].reshape(-1)
    ent = torch.zeros((ne, 4), dtype=torch.float32)
    ent[:, 3] = torch.tensor(_NAN_BITS, dtype=torch.int32).view(torch.float32)
    k = slot[slot >= 0]
    ck = c[k]
    c2r2 = (ck[:, 0] * ck[:, 0] + ck[:, 1] * ck[:, 1]) + ck[:, 2] * ck[:, 2] \
        - r[k] * r[k]
    ent[slot >= 0] = torch.cat([ck, torch.where(
        act[k], c2r2, ent[0, 3])[:, None]], 1)
    bnd = torch.zeros((nb, 4), dtype=torch.float32)
    bnd[:ng] = torch.cat([ctr, rw[:, None]], 1)[order]

    head = torch.tensor([nlp, ng, n_large, n_small], dtype=torch.int32)
    out = torch.cat([head, ent.reshape(-1).view(torch.int32),
                     bnd.reshape(-1).view(torch.int32),
                     slot.to(torch.int32)])
    return out.to(scene_mat.device)


_TABLE_ARGTYPES = [
    ctypes.c_void_p,   # scene SoA (11, N)
    ctypes.c_int,      # N
    ctypes.c_void_p,   # cam row
    ctypes.c_void_p,   # table (table_words(N),) int32
]


def group_table_kernel(soa: torch.Tensor, cam_row: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/group_table.cu`` on the current stream over the (11, N)
    SoA scene a kernel takes; counts ``launch.group_table``."""
    launch = kio.entry("group_table", _TABLE_ARGTYPES, soa.device)
    n = soa.shape[1]
    if not 2 * GROUP <= n <= MAX_SLOTS:
        raise ValueError(f"a group table takes {2 * GROUP} to {MAX_SLOTS} "
                         f"slots, got {n}")
    table = torch.empty((table_words(n),), dtype=torch.int32, device=soa.device)
    launch(soa.data_ptr(), n, cam_row.data_ptr(), table.data_ptr())
    trace.count("launch.group_table")
    return table


def group_table(soa: torch.Tensor, cam_row: torch.Tensor,
                layout: str) -> Optional[torch.Tensor]:
    """The table a CUDA launch over the (11, N) SoA scene scans with, or
    None where it scans in one level (``uses_groups``)."""
    if not uses_groups(soa.shape[1], layout):
        return None
    return group_table_kernel(soa, cam_row)


def count_path(table: Optional[torch.Tensor]) -> None:
    """Count a scanning launch by the scan it runs."""
    trace.count("scan.one_level" if table is None else "scan.two_level")


class Table(NamedTuple):
    """A table's parts on the CPU."""
    n_large: int             # large entries, padded to 4
    n_groups: int
    entry: torch.Tensor      # (entries, 4) f32: cx, cy, cz, |c|^2 - r^2
    slot: torch.Tensor       # (entries,) int64, -1 for padding
    bound: torch.Tensor      # (n_groups, 4) f32: centre, widened radius
    large: int               # large slots
    small: int               # small slots


def unpack(table: torch.Tensor, n: int) -> Table:
    t = table.detach().cpu()
    ne, nb = entries(n), bounds(n)
    ent = t[HEAD:HEAD + 4 * ne].view(torch.float32).view(ne, 4)
    bnd = t[HEAD + 4 * ne:HEAD + 4 * ne + 4 * nb].view(torch.float32)
    slot = t[HEAD + 4 * ne + 4 * nb:].to(torch.int64)
    ng = int(t[1])
    return Table(int(t[0]), ng, ent, slot, bnd.view(nb, 4)[:ng],
                 int(t[2]), int(t[3]))


def double_table(table: Table, scene_mat: torch.Tensor) -> Table:
    """``table`` with the entries kernel 6 stages (``f64_render.cu``:
    ``stage_d``): each slot's (cx, cy, cz, |c|^2 - r^2) in double from the
    (N, 16) scene matrix's f32 values, (0, 0, 0, NaN) for padding."""
    m = scene_mat.detach().to("cpu", torch.float64)
    have = table.slot >= 0
    k = table.slot.clamp_min(0)
    c, r = m[k, 0:3], m[k, 3]
    c2r2 = ((c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]) + c[:, 2] * c[:, 2]) \
        - r * r
    live = have & (m[k, 10] > 0.5)
    ent = torch.cat([torch.where(have[:, None], c, 0.0), torch.where(
        live, c2r2, float("nan"))[:, None]], 1)
    return table._replace(entry=ent)


# (t_min, t_miss) of the scans: kernel 1's f32 constants, kernel 6's double
_LIMITS = {torch.float32: (T_MIN, T_MISS), torch.float64: (1.0e-3, 1.0e30)}


class ScanResult(NamedTuple):
    hit: torch.Tensor      # (R,) bool
    t: torch.Tensor        # (R,) f32 best numerator * (1 / a), double best
                           # numerator / a; T_MISS on a miss
    idx: torch.Tensor      # (R,) int64 winning slot (0 on a miss)
    opened: torch.Tensor   # (R // 32,) int64 groups each warp opened
    tests: torch.Tensor    # (R // 32,) int64 slot tests each warp issued


def _vec(v):
    return v.x, v.y, v.z


def _roots(e, o, d, a, d_dot_o, o2, tmin_a):
    """(m, R) root numerators of entries e (m, 4) for R rays; T_MISS-free
    validity mask beside them (slot_disc and take_root)."""
    ex, ey, ez, ew = (e[:, k:k + 1] for k in range(4))
    ox, oy, oz = _vec(o)
    dx, dy, dz = _vec(d)
    h = ((ex * dx + ey * dy) + ez * dz) - d_dot_o
    cc = (ew + o2) - 2.0 * ((ex * ox + ey * oy) + ez * oz)
    disc = h * h - a * cc
    pos = disc > 0.0
    sq = f32math.sqrt(torch.where(pos, disc, torch.ones_like(disc)))
    near = h - sq
    root = torch.where(near > tmin_a, near, h + sq)
    return root, pos & (root > tmin_a)


def _take(root, valid, slots, rows, best, win, t_miss):
    """Merge the least (root, slot) pair of each ray's valid entries among
    ``rows`` (rays that test them) into (best, win)."""
    big = torch.full_like(root, t_miss)
    r = torch.where(valid, root, big)
    rmin = r.amin(0)
    cand = valid & (r == rmin)
    smin = torch.where(cand, slots[:, None], torch.full_like(
        cand, 1 << 62, dtype=torch.int64)).amin(0)
    upd = rows & (rmin <= best) & ((rmin < best) | (smin < win)) & cand.any(0)
    return torch.where(upd, rmin, best), torch.where(upd, smin, win)


def model_scan(table: Table, o, d, active: torch.Tensor) -> ScanResult:
    """The two-level scan of ``ScanHit`` for R rays (R a multiple of 32;
    lanes 32k..32k+31 a warp) with the kernel's arithmetic, on the CPU: in
    f32 on a table as built, or, on ``double_table``'s, in double as
    kernel 6 scans (its t = numerator / a). ``active`` marks the lanes in
    the scan (the warp's vote is among them); the counts are the count
    mode's for one scan of each warp with an active lane."""
    dt = table.entry.dtype
    t_min, t_miss = _LIMITS[dt]
    o = type(o)(*(x.detach().cpu().to(dt) for x in _vec(o)))
    d = type(d)(*(x.detach().cpu().to(dt) for x in _vec(d)))
    active = active.detach().cpu()
    ox, oy, oz = _vec(o)
    dx, dy, dz = _vec(d)
    dd = (dx * dx + dy * dy) + dz * dz
    a = torch.clamp_min(dd, 1e-12)
    d_dot_o = (dx * ox + dy * oy) + dz * oz
    o2 = (ox * ox + oy * oy) + oz * oz
    tmin_a = torch.tensor(t_min, dtype=dt) * a
    R = a.shape[0]
    best = torch.full((R,), t_miss, dtype=dt)
    win = torch.zeros((R,), dtype=torch.int64)
    every = torch.ones((R,), dtype=torch.bool)
    live = active.view(-1, WARP).any(1)
    tests = torch.where(live, table.n_large, 0).to(torch.int64)
    opened = torch.zeros_like(tests)
    if table.n_large:
        e = table.entry[:table.n_large]
        root, valid = _roots(e, o, d, a, d_dot_o, o2, tmin_a)
        best, win = _take(root, valid, table.slot[:table.n_large], every,
                          best, win, t_miss)
    wide = ~((dd >= 1e-12) & (dd <= SAFE) & (o2 <= SAFE))
    pad_o = torch.tensor(PAD, dtype=dt) * f32math.sqrt(o2)
    for g in range(table.n_groups):
        b = table.bound[g].to(dt)
        bx, by, bz = b[0], b[1], b[2]
        rr = b[3] + pad_o
        h = ((bx * dx + by * dy) + bz * dz) - d_dot_o
        c2r2 = ((bx * bx + by * by) + bz * bz) - rr * rr
        cc = (c2r2 + o2) - 2.0 * ((bx * ox + by * oy) + bz * oz)
        disc = h * h - a * cc
        pos = disc > 0.0
        sq = f32math.sqrt(torch.where(pos, disc, torch.ones_like(disc)))
        can = wide | (pos & (h + sq > tmin_a) & (h - sq < best))
        warp_open = (can & active).view(-1, WARP).any(1)
        if not bool(warp_open.any()):
            continue
        opened += warp_open.long()
        tests += warp_open.long() * GROUP
        p = table.n_large + g * GROUP
        rows = warp_open.repeat_interleave(WARP)
        root, valid = _roots(table.entry[p:p + GROUP], o, d, a, d_dot_o, o2,
                             tmin_a)
        best, win = _take(root, valid, table.slot[p:p + GROUP], rows, best,
                          win, t_miss)
    hit = best < t_miss
    t = best * (1.0 / a) if dt == torch.float32 else best / a
    t = torch.where(hit, t, torch.full_like(best, t_miss))
    return ScanResult(hit, t, torch.where(hit, win, 0), opened, tests)
