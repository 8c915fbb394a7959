"""Multiple devices over ``torch.distributed``: one process per device.

The counterpart of ``raytracingincuda_tpu/parallel/mesh.py``. JAX shards
the pixel axis over a device mesh inside one program; the torch idiom is
one process (rank) per device, launched by ``torchrun``. A rank renders a
contiguous slice of the padded lane axis (``lane_slice``), and the pixel
math never depends on the slice: every draw is keyed on (pixel, sample,
bounce, draw), so sharded and single-process images are the same bits.

  * ``maybe_initialize_distributed`` joins the process group that the
    launcher describes through torch's ``env://`` variables (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
    without them it does nothing.
  * ``make_mesh`` returns this rank's ``Mesh``: the group, rank, world,
    device, and the axis names and shape. A 2-D ('dp', 'sp') mesh
    flattens to pixel shards in rank order, as JAX's ``P(None,
    mesh.axis_names)`` does.
  * ``gather_lanes`` assembles the ranks' lane rows on every rank with one
    ``all_reduce`` of a zero-filled full buffer: exact, because the
    supports are disjoint and radiance is >= 0. gloo takes CUDA tensors
    for ``broadcast`` and ``all_reduce`` only, so this one collective
    serves both backends.
  * ``all_reduce_sum`` sums a rank's partial sums (one ``all_reduce`` of
    every tensor given, flattened into one buffer), and ``reduce_grads``
    does the same for the gradients reaching a set of leaves.

Both collectives' sites are span ``rt.all_reduce`` and count
``all_reduce.calls`` and ``all_reduce.numel`` (``utils/trace.py``).

The backend is explicit: ``nccl`` for ranks on distinct cards, ``gloo``
for the CPU and for ranks that share one card; ``nccl`` with two ranks on
one card (or none) raises and names ``gloo``.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils import trace

# Lanes per CUDA block, the lane format of ops/kernel_io.py: every rank's
# slice is a multiple of it, so padding goes to PAD * world.
PAD = 128
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class Mesh(NamedTuple):
    group: Optional[object]   # the process group (None: one process)
    rank: int
    world: int
    device: torch.device      # this rank's device
    axis_names: tuple
    shape: tuple


def _local() -> tuple:
    """(local rank, ranks on this host) from the launcher's variables."""
    return (int(os.environ.get("LOCAL_RANK", "0")),
            int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1"))))


def _shared_card() -> bool:
    """True when this host's ranks do not each have a card of their own."""
    return _local()[1] > torch.cuda.device_count()


def maybe_initialize_distributed(backend: Optional[str] = None) -> None:
    """Join the process group the launcher's ``env://`` variables describe
    (``torchrun`` sets them); a no-op without them, or when a group
    already exists. ``backend`` None: gloo where this host's ranks share
    a card (or have none), else ``cpu:gloo,cuda:nccl``."""
    if dist.is_initialized() or not all(k in os.environ for k in _ENV):
        return
    if backend is None:
        backend = "gloo" if _shared_card() else "cpu:gloo,cuda:nccl"
    if "nccl" in backend and _shared_card():
        raise ValueError(
            f"backend {backend!r} needs a card for each rank: "
            f"{_local()[1]} ranks share {torch.cuda.device_count()} card(s) "
            "here; use backend='gloo'")
    dist.init_process_group(backend=backend, init_method="env://")


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    device given without an index (or None, which means 'cuda'), the CPU
    for 'cpu', else ``device`` as given. The port's one device rule
    (``device.resolve_device``) applies: a CUDA device without CUDA
    raises, and nothing falls back to the CPU."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _local()[0] % torch.cuda.device_count())
    return device


def world_size() -> int:
    """The launched world (1 without a launcher)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: int = 0, axis_names: Sequence[str] = ("dp",),
              backend: Optional[str] = None, device=None) -> Mesh:
    """This rank's mesh over the launched world (``n_devices`` 0), or over
    exactly ``n_devices`` ranks, which must be the world: JAX takes the
    first ``n_devices`` devices, a process group has every rank or none.
    For 2-D ('dp', 'sp') meshes the world is factored as evenly as
    possible, favouring 'dp'. ``device`` as ``rank_device``."""
    maybe_initialize_distributed(backend)
    world = world_size()
    if n_devices and n_devices != world:
        raise ValueError(
            f"n_devices={n_devices} but the launched world has {world} "
            f"rank(s): launch one process per device (torchrun "
            f"--nproc_per_node {n_devices}) or pass 0")
    names = tuple(axis_names)
    if len(names) == 1:
        shape = (world,)
    elif len(names) == 2:
        sp = max(f for f in range(1, int(world ** 0.5) + 1) if world % f == 0)
        shape = (world // sp, sp)
    else:
        raise ValueError("at most 2 mesh axes supported ('dp', 'sp')")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.group.WORLD if world > 1 else None,
                dist.get_rank() if world > 1 else 0, world, dev, names, shape)


def validate(mesh) -> None:
    """Raise unless ``mesh`` is None or a ``Mesh``."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), "
                        f"got {type(mesh).__name__}")


def sharded(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` (None, or a ``Mesh``) spans more than one rank."""
    validate(mesh)
    return mesh is not None and mesh.world > 1


def padded_lanes(num_lanes: int, mesh: Optional[Mesh]) -> int:
    """``num_lanes`` padded to a multiple of PAD lanes on every rank: the
    lanes of the whole world, which ``kernel_io.lane_setup`` holds to
    ``kernel_io.MAX_LANES``."""
    m = PAD * (mesh.world if sharded(mesh) else 1)
    return -(-num_lanes // m) * m


def lane_slice(padded: int, world: int, rank: int) -> slice:
    """Rank ``rank``'s contiguous share of ``padded`` lanes (a multiple of
    ``PAD * world``)."""
    if padded % (PAD * world):
        raise ValueError(f"{padded} lanes are not a multiple of {PAD} x "
                         f"{world} ranks")
    per = padded // world
    return slice(rank * per, (rank + 1) * per)


def local_slice(padded: int, mesh: Optional[Mesh]) -> slice:
    if not sharded(mesh):
        return slice(0, padded)
    return lane_slice(padded, mesh.world, mesh.rank)


class _Gather(torch.autograd.Function):
    """Forward: the rank's lane rows placed in a zero-filled full buffer,
    summed over the ranks. Backward: the rows of the (identical on every
    rank) cotangent that this rank produced."""

    @staticmethod
    def forward(ctx, rows, group, lanes, padded):
        with trace.span("rt.all_reduce"):
            full = rows.new_zeros((*rows.shape[:-1], padded))
            full[..., lanes] = rows
            _all_reduce(full, group)
        ctx.lanes = lanes
        return full

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lanes], None, None, None


def gather_lanes(mesh: Optional[Mesh], rows: torch.Tensor,
                 padded: int) -> torch.Tensor:
    """(..., local lanes) rows of this rank -> (..., padded) on every rank,
    by one exact ``all_reduce`` (the ranks' supports are disjoint and the
    values >= 0). Differentiable."""
    if not sharded(mesh):
        return rows
    return _Gather.apply(rows, mesh.group, local_slice(padded, mesh), padded)


def all_reduce_sum(mesh: Optional[Mesh], *tensors: torch.Tensor) -> tuple:
    """The sums over the ranks of each tensor, by one ``all_reduce`` of one
    flat buffer (they share a dtype and a device)."""
    if not sharded(mesh):
        return tensors
    with trace.span("rt.all_reduce"):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        _all_reduce(flat, mesh.group)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
    return tuple(out)


def _all_reduce(flat: torch.Tensor, group) -> None:
    """``dist.all_reduce`` (a sum, in place), counted."""
    trace.count("all_reduce.calls")
    trace.count("all_reduce.numel", flat.numel())
    dist.all_reduce(flat, group=group)


class _ReduceGrads(torch.autograd.Function):
    """Identity forward; backward: one ``all_reduce`` of every leaf's
    cotangent, flattened into one buffer."""

    @staticmethod
    def forward(ctx, mesh, *leaves):
        ctx.mesh = mesh
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *all_reduce_sum(ctx.mesh, *grads))


def reduce_grads(mesh: Optional[Mesh], leaves: list) -> list:
    """``leaves`` unchanged, but the gradients that reach them through the
    returned tensors are summed over the ranks (one ``all_reduce``). For
    code whose ranks each differentiate their own pixels."""
    if not sharded(mesh) or not any(t.requires_grad for t in leaves):
        return leaves
    return list(_ReduceGrads.apply(mesh, *leaves))
