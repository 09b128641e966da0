"""Corpus sharding over a ``torch.distributed`` mesh.

The JAX package's one mesh axis, ``shard``, in PyTorch's idiom: one rank
per card (or per process), rank ``r`` of ``W`` owning the IVF lists
``l % W == r`` or the ``r``-th contiguous block of a flat corpus. Queries,
centroids and codebooks are replicated; each rank scans its own shard and
the ranks' top-k lists merge by one all-gather (``topk_merge.py``).

The build runs over the same mesh: each rank trains on its block of the
sample (``shard_rows``) and the Lloyd sums cross it by
``sum_in_rank_order``, which adds the ranks' partials in rank order, so
every rank holds the same bits; the fill deals a reader's row groups
round-robin (``deal``) before any is read; small records (a rank's stage
seconds) travel by ``gather_objects``.

A ``Mesh`` is a small value: ``rank``, ``size``, ``device``, ``group``.
``build_mesh()`` in a process that joined no group gives ``W = 1`` with
no group, and every index then takes its single-card path: no collective
runs. ``init_distributed`` joins a group first.

Two axes, as the JAX package's ``(shard, tp)`` mesh. ``build_mesh(tp=)``
places rank ``r`` of ``W`` at shard ``r // tp`` and tp index ``r % tp``
(JAX's ``reshape(W // tp, tp)``: the tp ranks of a shard are
consecutive). The encoder runs its batch rows over ``shard`` and its
weights over ``tp`` (``models/``, ``parallel/sharding.py``): its
all-reduces run in ``tp_group`` (this rank's shard), its all-gather of
rows in ``shard_group`` (the ranks of this tp index, one per shard).
The search structures use ``shard`` only and are replicated over ``tp``:
every index takes ``shard_view()`` (``index_mesh``), a mesh of
``n_shard`` ranks over ``shard_group``, so the tp ranks of a shard hold
the same lists and run the same searches. At ``tp = 1`` both views are
the mesh itself.

Backends. ``nccl`` (the default for a CUDA device) runs one rank per card
with its collectives on the card; ``gloo`` (the default on the CPU) is a
host transport, and the backend for ranks that share one card, which
NCCL refuses. Under gloo a collective copies its tensors through host
memory: a batch's queries and its ``k`` candidates per query and rank.
Every collective runs under the group's finite timeout, so a lost rank
is an error, not an idle wait.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

# seconds a collective may wait for the other ranks before it fails
DEFAULT_TIMEOUT_S = 600.0
BACKENDS = ("nccl", "gloo")
_LOOPBACK = ("localhost", "127.0.0.1", "::1")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the corpus mesh."""

    rank: int
    size: int
    device: torch.device
    group: object | None = None      # the process group; None: no collective runs
    backend: str | None = None
    timeout_s: float = DEFAULT_TIMEOUT_S
    tp: int = 1                      # the tp axis' extent; size // tp shards
    tp_group: object | None = None   # this rank's shard (its tp ranks); None at tp 1
    shard_group: object | None = None  # this tp index's ranks, one per shard (tp > 1)

    @property
    def collective(self) -> bool:
        """Whether searches merge across ranks (any group, W = 1 included)."""
        return self.group is not None

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def shard_rank(self) -> int:
        return self.rank // self.tp

    @property
    def n_shard(self) -> int:
        return self.size // self.tp

    def shard_view(self) -> "Mesh":
        """The ``shard`` axis alone: ``n_shard`` ranks over ``shard_group``,
        this rank at ``shard_rank`` (the mesh itself at tp 1)."""
        if self.tp == 1:
            return self
        return Mesh(self.shard_rank, self.n_shard, self.device, self.shard_group,
                    self.backend, self.timeout_s)

    def tp_view(self) -> "Mesh":
        """The ``tp`` axis alone: this rank's shard as a mesh of one shard
        of ``tp`` ranks over ``tp_group`` (``W = 1`` with no group at tp 1)."""
        if self.tp == 1:
            return Mesh(0, 1, self.device, timeout_s=self.timeout_s)
        return Mesh(self.tp_rank, self.tp, self.device, self.tp_group, self.backend,
                    self.timeout_s, tp=self.tp, tp_group=self.tp_group)

    def owned(self, n_lists: int) -> np.ndarray:
        """[n_lists] bool: the lists this rank owns (``l % size == rank``)."""
        return np.arange(n_lists) % self.size == self.rank


def _local_rank(rank: int) -> int:
    """The rank's index among its host's ranks: ``LOCAL_RANK`` (torchrun),
    else ``rank`` modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def _rank_device(device, rank: int) -> torch.device:
    """``device`` with a CUDA index filled in: ``cuda:<local rank>``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank(rank))
    return dev


def _ranks_on_this_host(world: int, coordinator: str | None) -> int | None:
    """``LOCAL_WORLD_SIZE`` (torchrun), else every rank where the
    coordinator is a loopback address; None where it cannot be known."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if coordinator is not None and coordinator.rsplit(":", 1)[0].strip("[]") in _LOOPBACK:
        return world
    return None


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None, *,
                     device=None, timeout_s: float = DEFAULT_TIMEOUT_S, tp: int = 1) -> Mesh:
    """Join the process group and return this rank's ``Mesh``.

    ``coordinator`` is ``HOST:PORT`` of rank 0's rendezvous
    (``tcp://HOST:PORT``); without it the group forms from torchrun's
    environment (``env://``: ``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``).
    ``device`` defaults to ``cuda:<local rank>``; ``backend`` to
    ``nccl`` for a CUDA device and ``gloo`` for the CPU. ``nccl`` with more
    ranks on this host than cards is refused here, before any rank
    blocks: ranks that share a card take ``gloo``. The rank's card is
    made current before any CUDA op. ``tp``: the tp axis' extent
    (``build_mesh``); a ``W`` it does not divide is refused before the
    group forms."""
    if coordinator is None:
        init_method = "env://"
        world = int(num_processes or os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"] if process_id is None else process_id)
    else:
        if not num_processes:
            raise ValueError("--coordinator requires --num-processes")
        if process_id is None:
            if "RANK" not in os.environ:
                raise ValueError("--coordinator requires --process-id (or RANK)")
            process_id = int(os.environ["RANK"])
        init_method, world, rank = f"tcp://{coordinator}", int(num_processes), int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    _check_tp(world, tp)
    dev = _rank_device(device, rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices; the CPU takes gloo")
        local, cards = _ranks_on_this_host(world, coordinator), torch.cuda.device_count()
        if local is not None and local > cards:
            raise ValueError(
                f"nccl runs one rank per card: {local} ranks on this host, {cards} "
                f"card(s); ranks that share a card take the gloo backend")
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return build_mesh(dev, timeout_s=timeout_s, tp=tp)


def _check_tp(world: int, tp: int) -> None:
    if isinstance(tp, bool) or not isinstance(tp, int) or tp < 1 or world % tp:
        raise ValueError(f"{world} rank(s) not divisible by tp={tp!r}")


def build_mesh(device=None, *, timeout_s: float = DEFAULT_TIMEOUT_S, tp: int = 1) -> Mesh:
    """The mesh of this process: the initialized default group's ranks
    as ``W // tp`` shards of ``tp`` ranks (module docstring), or ``W = 1``
    with no group (no collective runs). At ``tp > 1`` every rank must
    call this, with the same ``tp``: each makes every tp and shard group,
    in the same order (``dist.new_group`` is collective over the world)."""
    if not (dist.is_available() and dist.is_initialized()):
        _check_tp(1, tp)
        return Mesh(0, 1, resolve_device(device), timeout_s=timeout_s)
    rank, world = dist.get_rank(), dist.get_world_size()
    _check_tp(world, tp)
    dev = resolve_device(_rank_device(device, rank))
    if tp == 1:
        return Mesh(rank, world, dev, dist.group.WORLD, dist.get_backend(), timeout_s)
    timeout = datetime.timedelta(seconds=timeout_s)
    tp_groups = [dist.new_group(list(range(s * tp, (s + 1) * tp)), timeout=timeout)
                 for s in range(world // tp)]
    shard_groups = [dist.new_group(list(range(j, world, tp)), timeout=timeout)
                    for j in range(tp)]
    return Mesh(rank, world, dev, dist.group.WORLD, dist.get_backend(), timeout_s, tp=tp,
                tp_group=tp_groups[rank // tp], shard_group=shard_groups[rank % tp])


def rank_mesh(mesh: Mesh | None, device=None) -> Mesh:
    """``mesh`` (whose device a ``device`` naming another may not
    contradict), or ``W = 1`` with no group on ``device``."""
    if mesh is None:
        return Mesh(0, 1, resolve_device(device))
    if device is not None:
        d = torch.device(device)
        if d.type != mesh.device.type or (d.index is not None and d != mesh.device):
            raise ValueError(f"device {d} is not the mesh's {mesh.device}")
    return mesh


def index_mesh(mesh: Mesh | None, device=None) -> Mesh:
    """An index's mesh: the ``shard`` axis of ``mesh`` (``rank_mesh``;
    the index lives on the mesh's device, replicated over ``tp``)."""
    return rank_mesh(mesh, device).shard_view()


def shutdown_distributed(mesh: Mesh) -> None:
    """Leave the group once every rank is here (``process_barrier``)."""
    if mesh.collective:
        process_barrier(mesh)
        dist.destroy_process_group()


def _stage_device(mesh: Mesh) -> torch.device:
    """Where a collective's tensors live: the card under nccl, host
    memory under gloo."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """[W, *t.shape]: every rank's ``t`` (equal shapes), rank-major, on
    ``t``'s device. Without a group: ``t[None]``."""
    if not mesh.collective:
        return t[None]
    src = t.contiguous().to(_stage_device(mesh))
    out = torch.empty((mesh.size,) + tuple(t.shape), dtype=t.dtype, device=src.device)
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, src, group=mesh.group)
    else:
        dist.all_gather(list(out.unbind(0)), src, group=mesh.group)
    return out.to(t.device)


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """The mesh's rank ``src``'s ``t`` on every rank (a copy on ``t``'s
    device; the other ranks pass a tensor of the same shape and dtype)."""
    if not mesh.collective:
        return t
    buf = t.contiguous().to(_stage_device(mesh), copy=True)
    dist.broadcast(buf, dist.get_global_rank(mesh.group, src), group=mesh.group)
    return buf.to(t.device)


def all_reduce(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over the mesh's ranks of ``t`` (equal shapes and dtypes),
    on ``t``'s device: one ring all-reduce, which hands every rank the
    same bits (``t`` itself may be overwritten). Without a group: ``t``."""
    if not mesh.collective:
        return t
    buf = t.contiguous().to(_stage_device(mesh))
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(t.device)


def sum_in_rank_order(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``t`` (equal shapes and dtypes on every
    rank), added rank 0 first: the same bits on every rank, and from run
    to run at a fixed W. An all-reduce fixes no order of its adds, so the
    reduction is spelled out: one all-to-all hands rank ``r`` every
    rank's ``r``-th slice of the flattened tensor, rank ``r`` adds them in
    rank order, and one all-gather hands every rank every slice's sum.
    Each rank moves about ``2 (W - 1) / W`` of the tensor's bytes, as a
    ring all-reduce does. At W = 1 the sum is ``t`` itself. Without a
    group: ``t``."""
    if not mesh.collective:
        return t
    w, n = mesh.size, t.numel()
    per = -(-n // w)
    src = torch.zeros(w * per, dtype=t.dtype, device=_stage_device(mesh))
    src[:n] = t.reshape(-1)
    parts = torch.empty_like(src)
    dist.all_to_all_single(parts, src, group=mesh.group)
    parts = parts.view(w, per)
    mine = parts[0].clone()
    for r in range(1, w):
        mine += parts[r]
    return all_gather(mesh, mine).reshape(-1)[:n].reshape(t.shape).to(t.device)


def gather_objects(mesh: Mesh, obj) -> list:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` without a
    group): small records such as a rank's stage seconds."""
    if not mesh.collective:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def process_barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh is here (no-op without a group).
    One small all-gather, so it runs under the group's timeout on either
    backend."""
    all_gather(mesh, torch.zeros(1, dtype=torch.int64))


def deal(n: int, mesh: Mesh) -> range:
    """This rank's units (row groups, chunks) of ``n`` dealt round-robin,
    unit ``i`` to rank ``i % W``: the fill and the streamed tune oracle
    deal a reader's row groups so, before any is read."""
    return range(mesh.rank, n, mesh.size)


def shard_rows(n: int, mesh: Mesh, chunk: int = 1) -> tuple[int, int, int]:
    """This rank's block of an ``n``-row corpus: ``(lo, hi, per)``, rows
    ``[lo, hi)`` of blocks of ``per`` rows (a multiple of ``chunk``), the
    JAX package's padded row sharding; ``hi - lo`` may be 0."""
    per = -(-(-(-n // mesh.size)) // chunk) * chunk      # ceil(n / W), up to chunk
    lo = mesh.rank * per
    return lo, max(lo, min(lo + per, n)), per
