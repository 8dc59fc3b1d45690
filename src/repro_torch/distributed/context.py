"""One rank's view of a data-parallel job, on ``torch.distributed``.

``init_distributed(world_size, rank, coordinator, device)`` joins the
job's process group (rank 0 hosts the TCP store at ``coordinator``) and
returns a :class:`DistContext`.  ``world_size=1`` starts no process
group, so the same trainer code serves both cases and calls no
collective.

* **The device**: the one the caller passed; ``"cuda"`` (or none, with
  a card) means ``cuda:{rank % torch.cuda.device_count()}``.  Without a
  card and without ``device="cpu"`` the rank raises, as
  :func:`repro_torch.kernels.common.resolve_device` does.
* **The backend**, fixed before the group starts: ``gloo`` on the CPU;
  ``nccl`` when every rank has a card of its own; ``gloo`` on the CUDA
  tensors when ranks share a card (NCCL refuses two ranks on one
  device).  Nothing swaps one backend or device for another after a
  failure.

* **The sharded collectives**: the parameter gather and the gradient
  reduce-scatter of the sharded layouts (:mod:`repro_torch.sharding.
  fsdp`) are ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on
  every backend.  gloo takes both, and ``all_to_all_single``, on CPU
  tensors (torch 2.13) and on CUDA tensors of two ranks that share an
  H100 (torch 2.11), in f32 and bf16, with the right sums.

Collectives run on the rank's own device.  The gradient sum
(:meth:`DistContext.allreduce_`) reduces flat buckets of the leaves in
their given order; a small gather (:meth:`DistContext.allgather`) is a
sum of one-hot rank slots, exact for any value.  Every collective's
bytes are counted per rank by the analytic model's mechanism
(``collective_bytes``; ``repro_torch.analysis.analytic.
collective_bytes_per_chip``'s names, ``tp_allreduce`` among them), or by
the port's own name where that model has no term (the sequence-parallel
mechanisms of ``sharding/sp.py``; the decode state's ``state_reshard``,
``qkv_allgather``, ``softmax_combine``, ``xbc_allgather`` and
``conv_allgather`` of ``sharding/tp.py``), in
its ring convention over the N ranks of its group: a gather or a
reduce-scatter of F full bytes moves ``(N-1)/N * F`` a rank, an
all-reduce twice that.

* **Groups**: each collective takes a :class:`Group` (a grid's data,
  model, pod, batch or plane group, :class:`repro_torch.sharding.grid.
  RankGrid`), by default the whole world.  A group of one rank is the
  identity; the grid makes one ``torch.distributed`` subgroup per set of
  ranks, on the world's backend (gloo on CUDA tensors where ranks share
  a card).  ``collective_groups`` keeps each mechanism's bytes by the
  ranks of the group it ran over.

* **One rank on meta** (:func:`meta_context`): a :class:`MetaDistContext`
  stands for rank r of an N-rank job with no process group.  Its
  collectives return ``meta`` tensors of the shapes the real ones give
  and count the same bytes, calls and groups, calling nothing in
  ``torch.distributed``; what reads a value (:meth:`DistContext.agree`)
  raises.  The dry run traces one rank of the production mesh through
  it (:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

# the gradient all-reduce's flat buckets: consecutive leaves of one dtype
# up to this many bytes (a larger leaf is reduced alone, in place)
BUCKET_BYTES = 128 << 20


@dataclasses.dataclass(frozen=True)
class Group:
    """Some ranks of the world that reduce together: their global
    ranks in group order, this rank's index among them, and the
    ``torch.distributed`` group (``None``: the default group, which a
    group of the whole world uses)."""

    ranks: Tuple[int, ...]
    index: int
    pg: Optional[object] = None

    @property
    def size(self) -> int:
        return len(self.ranks)


def rank_device(world_size: int, rank: int, device=None) -> torch.device:
    """A rank's device: at world 1 :func:`resolve_device`'s; beyond it
    the given one, where ``cuda`` (or none) means ``cuda:{rank %
    device_count}``."""
    if world_size == 1:
        return resolve_device(device)
    dev = resolve_device(device) if device is None else torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda", rank % count)


def choose_backend(world_size: int, device=None) -> str:
    """The backend for the ``device`` the caller asked for (none means
    ``cuda``): ``nccl`` when it is ``cuda`` with no index, which
    :func:`rank_device` binds to ``cuda:{rank % device_count}``, and
    there is a card for every rank; else ``gloo`` (the CPU, an explicit
    ``cuda:i`` every rank shares, or fewer cards than ranks).  The
    port's gangs run on one host, so the local cards are the world's."""
    dev = torch.device("cuda" if device is None else device)
    if (dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def init_distributed(world_size: int = 1, rank: int = 0,
                     coordinator: Optional[str] = None,
                     device=None) -> "DistContext":
    """Join the job's process group (when ``world_size > 1``) and return
    the rank's context."""
    world_size, rank = int(world_size), int(rank)
    if world_size > 1:
        if coordinator is None:
            raise ValueError("world_size > 1 requires coordinator "
                             "('host:port' of rank 0)")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world of {world_size}")
    dev = rank_device(world_size, rank, device)
    backend = None
    if world_size > 1:
        backend = choose_backend(world_size, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=world_size, rank=rank)
    return DistContext(world_size=world_size, rank=rank,
                       coordinator=coordinator, device=dev, backend=backend)


@dataclasses.dataclass
class DistContext:
    """One rank of a data-parallel job, and what its collectives cost."""

    world_size: int
    rank: int
    coordinator: Optional[str]
    device: torch.device
    backend: Optional[str]          # None at world 1: no process group
    allreduce_calls: int = 0
    allreduce_bytes: int = 0
    allreduce_s: float = 0.0
    allgather_s: float = 0.0
    agree_calls: int = 0
    # per rank, by mechanism: ring-convention bytes and calls
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_calls: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    # per mechanism: ring-convention bytes by the ranks of the group
    collective_groups: Dict[str, Dict[Tuple[int, ...], float]] = (
        dataclasses.field(default_factory=dict))

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    def row_range(self, global_rows: int) -> tuple:
        """The contiguous ``[lo, hi)`` rows of the global batch this rank
        owns."""
        if global_rows % self.world_size:
            raise ValueError(f"global batch {global_rows} not divisible "
                             f"by {self.world_size} ranks")
        per = global_rows // self.world_size
        return self.rank * per, (self.rank + 1) * per

    # ------------------------------------------------------ collectives
    @property
    def world(self) -> Group:
        """The whole world as a :class:`Group` (the default group)."""
        return Group(tuple(range(self.world_size)), self.rank)

    def allgather(self, value, group: Optional[Group] = None
                  ) -> torch.Tensor:
        """Every rank's ``value`` (a small tensor or number) in ``group``
        (default: the world), stacked to ``(group size, ...)`` on this
        rank's device.  Each rank writes its own slot of zeros and the
        slots are summed, so the result is exact on any backend and
        device."""
        group = group or self.world
        t = torch.as_tensor(value, device=self.device)
        if group.size == 1:
            return t[None]
        t0 = time.perf_counter()
        buf = torch.zeros((group.size,) + tuple(t.shape),
                          dtype=t.dtype, device=self.device)
        buf[group.index] = t
        torch.distributed.all_reduce(buf, group=group.pg)
        self.allgather_s += time.perf_counter() - t0
        return buf

    def agree(self, value, what: str = "value"):
        """Raise unless every rank holds the same ``value``; return it.
        Catches a rank that resumed another step before it poisons a
        collective."""
        self.agree_calls += 1
        gathered = self.allgather(value).cpu()
        if not all(torch.equal(gathered[0], g) for g in gathered[1:]):
            raise RuntimeError(f"ranks disagree on {what}: "
                               f"{gathered.tolist()}")
        return value

    def _count(self, mechanism: str, full_bytes: int, passes: int,
               group: Optional[Group] = None) -> None:
        group = group or self.world
        n = group.size
        moved = passes * full_bytes * (n - 1) / n
        self.collective_bytes[mechanism] = (
            self.collective_bytes.get(mechanism, 0.0) + moved)
        self.collective_calls[mechanism] = (
            self.collective_calls.get(mechanism, 0) + 1)
        by_group = self.collective_groups.setdefault(mechanism, {})
        by_group[group.ranks] = by_group.get(group.ranks, 0.0) + moved

    def all_gather(self, shard: torch.Tensor, dim: int,
                   mechanism: str = "fsdp_allgather",
                   group: Optional[Group] = None) -> torch.Tensor:
        """The ``group``'s (default: the world's) ``shard``s concatenated
        along ``dim``, in group order (one ``all_gather_into_tensor`` of
        the shards with ``dim`` moved first; the result is a view with
        ``dim`` back in place)."""
        group = group or self.world
        if group.size == 1:
            return shard
        x = shard.movedim(dim, 0).contiguous()
        out = x.new_empty((group.size * x.shape[0],) + x.shape[1:])
        torch.distributed.all_gather_into_tensor(out, x, group=group.pg)
        self._count(mechanism, out.numel() * out.element_size(), 1, group)
        return out.movedim(0, dim)

    def reduce_scatter(self, full: torch.Tensor, dim: int,
                       mechanism: str = "grad_reducescatter",
                       group: Optional[Group] = None) -> torch.Tensor:
        """This rank's block along ``dim`` of ``full`` summed over the
        ``group``'s ranks (default: the world; one
        ``reduce_scatter_tensor``)."""
        group = group or self.world
        if group.size == 1:
            return full
        x = full.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // group.size,) + x.shape[1:])
        torch.distributed.reduce_scatter_tensor(out, x, group=group.pg)
        self._count(mechanism, x.numel() * x.element_size(), 1, group)
        return out.movedim(0, dim)

    def all_to_all(self, t: torch.Tensor, mechanism: str,
                   group: Group) -> torch.Tensor:
        """``t``'s dim 0 split into ``group.size`` equal blocks, block
        ``j`` sent to the group's rank ``j``; returns the blocks received,
        in group order, in ``t``'s shape (one ``all_to_all_single``).
        Counts the ``(N-1)/N`` of ``t``'s bytes that leave the rank."""
        if group.size == 1:
            return t
        x = t.contiguous()
        out = torch.empty_like(x)
        torch.distributed.all_to_all_single(out, x, group=group.pg)
        self._count(mechanism, x.numel() * x.element_size(), 1, group)
        return out

    def all_reduce(self, t: torch.Tensor, mechanism: str,
                   group: Group, op: str = "sum") -> torch.Tensor:
        """``t`` reduced (``op``: ``"sum"`` or ``"max"``) over the
        ``group``'s ranks into a new tensor: the model axis's activation
        all-reduces (:mod:`repro_torch.sharding.tp`), counted, not
        timed (they run inside the step's forward and backward)."""
        out = t.contiguous().clone()
        if group.size == 1:
            return out
        red = (torch.distributed.ReduceOp.SUM if op == "sum"
               else torch.distributed.ReduceOp.MAX)
        torch.distributed.all_reduce(out, op=red, group=group.pg)
        self._count(mechanism, out.numel() * out.element_size(), 2, group)
        return out

    def allreduce_(self, tensors: List[torch.Tensor],
                   mechanism: str = "grad_reducescatter",
                   group: Optional[Group] = None) -> List[torch.Tensor]:
        """Sum ``tensors`` over the ``group``'s ranks (default: the
        world), in place: flat buckets of consecutive same-dtype tensors,
        in the order given (every rank gives the same), one
        ``all_reduce`` each.  The identity in a group of one.  Counts the
        calls, the bytes and the seconds (the card is synchronised around
        them, so the time is the reduction's), and the bytes under
        ``mechanism`` (the data-parallel gradient sum is the analytic
        model's ``grad_reducescatter``)."""
        group = group or self.world
        if group.size == 1 or not tensors:
            return tensors
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for bucket in _buckets(tensors):
            if len(bucket) == 1 and bucket[0].is_contiguous():
                flat = bucket[0]
                torch.distributed.all_reduce(flat, group=group.pg)
            else:
                flat = torch.cat([t.reshape(-1) for t in bucket])
                torch.distributed.all_reduce(flat, group=group.pg)
                off = 0
                for t in bucket:
                    n = t.numel()
                    t.copy_(flat[off:off + n].view_as(t))
                    off += n
            self.allreduce_calls += 1
            self.allreduce_bytes += flat.numel() * flat.element_size()
            self._count(mechanism, flat.numel() * flat.element_size(), 2,
                        group)
        if cuda:
            torch.cuda.synchronize(self.device)
        self.allreduce_s += time.perf_counter() - t0
        return tensors

    def close(self) -> None:
        """Leave the process group (nothing at world 1)."""
        if self.world_size > 1 and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


class MetaDistContext(DistContext):
    """Rank ``rank`` of a ``world_size``-rank job traced on ``meta``: no
    process group, the collectives of :class:`DistContext` on shapes
    alone.  Each returns what the real one returns, a ``meta`` tensor of
    its shape (an all-gather's blocks concatenated, a reduce-scatter's
    block, an all-reduce's clone, an all-to-all's like its input), and
    counts the same bytes and calls by mechanism and group; an in-place
    sum leaves its tensors as they are.  What reads a value raises."""

    def allgather(self, value, group: Optional[Group] = None
                  ) -> torch.Tensor:
        group = group or self.world
        t = torch.as_tensor(value, device=self.device)
        return t.new_empty((group.size,) + tuple(t.shape))

    def agree(self, value, what: str = "value"):
        raise RuntimeError(f"a rank traced on meta holds no {what} to "
                           f"agree on")

    def all_gather(self, shard: torch.Tensor, dim: int,
                   mechanism: str = "fsdp_allgather",
                   group: Optional[Group] = None) -> torch.Tensor:
        group = group or self.world
        if group.size == 1:
            return shard
        shape = list(shard.shape)
        shape[dim] *= group.size
        out = shard.new_empty(shape)
        self._count(mechanism, out.numel() * out.element_size(), 1, group)
        return out

    def reduce_scatter(self, full: torch.Tensor, dim: int,
                       mechanism: str = "grad_reducescatter",
                       group: Optional[Group] = None) -> torch.Tensor:
        group = group or self.world
        if group.size == 1:
            return full
        shape = list(full.shape)
        shape[dim] //= group.size
        self._count(mechanism, full.numel() * full.element_size(), 1,
                    group)
        return full.new_empty(shape)

    def all_to_all(self, t: torch.Tensor, mechanism: str,
                   group: Group) -> torch.Tensor:
        if group.size == 1:
            return t
        self._count(mechanism, t.numel() * t.element_size(), 1, group)
        return torch.empty_like(t)

    def all_reduce(self, t: torch.Tensor, mechanism: str,
                   group: Group, op: str = "sum") -> torch.Tensor:
        out = t.contiguous().clone()
        if group.size > 1:
            self._count(mechanism, out.numel() * out.element_size(), 2,
                        group)
        return out

    def allreduce_(self, tensors: List[torch.Tensor],
                   mechanism: str = "grad_reducescatter",
                   group: Optional[Group] = None) -> List[torch.Tensor]:
        group = group or self.world
        if group.size == 1 or not tensors:
            return tensors
        for bucket in _buckets(tensors):
            nbytes = sum(t.numel() * t.element_size() for t in bucket)
            self.allreduce_calls += 1
            self.allreduce_bytes += nbytes
            self._count(mechanism, nbytes, 2, group)
        return tensors

    def close(self) -> None:
        pass


def meta_context(world_size: int, rank: int) -> MetaDistContext:
    """Rank ``rank`` of a ``world_size``-rank job on the ``meta`` device
    (see :class:`MetaDistContext`)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world of {world_size}")
    return MetaDistContext(world_size=world_size, rank=rank,
                           coordinator=None, device=torch.device("meta"),
                           backend="meta")


def _buckets(tensors: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if (not out or out[-1][0].dtype != t.dtype
                or size + nbytes > BUCKET_BYTES):
            out.append([])
            size = 0
        out[-1].append(t)
        size += nbytes
    return out


def params_checksum(leaves: List[torch.Tensor]) -> np.ndarray:
    """Per-leaf f64 sums: equal on ranks that initialised equal
    parameters from one seed."""
    return torch.stack([t.sum(dtype=torch.float64) for t in leaves]).cpu(
        ).numpy()
