"""Process groups and collectives of the port's mesh (``parallel/mesh.py``).

The JAX package has no counterpart: XLA inserts its collectives itself.
Here every rank is a process of its own, started by torchrun
(:func:`init_parallel` reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``)
or by :func:`spawn`, and the collectives are ``torch.distributed`` calls.

The backend follows one rule, with no switch: NCCL when every rank has a
card of its own; gloo when ranks share a card, or on the CPU.  Gloo takes
CUDA tensors only for ``all_reduce`` and ``broadcast``, so under gloo every
collective on a CUDA tensor goes through a pinned host buffer
(``World.host_staged``): one copy to the host, the collective there, one
copy back.

``World.bytes_sent`` counts the payload a rank hands to the network: a
send counts its tensor; an all-gather counts the local piece once a peer,
(g - 1) * n; an all-reduce counts a ring's 2 (g - 1) / g * n; a broadcast
counts n on its source.

The autograd-aware collectives derive each backward from how the ranks
consume the result: :func:`enter_parallel` (identity; its gradient sums
the ranks' partial gradients), :func:`reduce_parallel` (a sum over the
ranks, consumed alike on every rank: its gradient passes as it is),
:func:`gather` (consumed alike on every rank: the gradient's local slice;
consumed differently per rank: a reduce-scatter) and :func:`split` (its
gradient is gathered)."""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass
class World:
    """This process's place among the ranks: its rank, their number, its
    device, the backend and whether collectives stage through the host."""
    rank: int
    size: int
    device: torch.device
    backend: str
    bytes_sent: int = 0

    @property
    def host_staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"


WORLD: World | None = None
_GROUPS: dict = {}


def backend_for(world: int, device) -> str:
    """'nccl' when each of ``world`` ranks has a card of its own, else
    'gloo' (ranks share a card, or run on the CPU)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def rank_device(rank: int, device) -> torch.device:
    """The device of ``rank``: the visible cards in turn, or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _init(rank: int, size: int, device, local=None, **kw) -> World:
    global WORLD
    dev = rank_device(rank if local is None else local, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(size, device)
    dist.init_process_group(backend, rank=rank, world_size=size,
                            timeout=TIMEOUT, **kw)
    _GROUPS.clear()
    WORLD = World(rank, size, dev, backend)
    return WORLD


def init_parallel(device="cuda") -> World:
    """The world of a rank that torchrun started (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): its process group,
    with the backend of :func:`backend_for`; the rank's card is
    ``LOCAL_RANK`` among the visible ones."""
    if WORLD is not None:
        return WORLD
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    return _init(rank, size, device, local, init_method="env://")


def launched() -> bool:
    """Whether torchrun started this process (its variables are set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def shutdown() -> None:
    global WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUPS.clear()
    WORLD = None


def _entry(rank, fn, size, device, tmp, args, threads):
    if threads is not None:
        torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(tmp, "store"), size)
    world = _init(rank, size, device, store=store)
    try:
        result = fn(world, *args)
        torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
    finally:
        shutdown()


def spawn(fn, size: int, device="cuda", args=(), threads=None) -> list:
    """Run ``fn(world, *args)`` on ``size`` ranks, each a process started
    with the ``spawn`` method (``fork`` is ruled out once the parent has
    initialised CUDA), and return their results in rank order.  ``fn``
    lives in an importable module; its result is saved with ``torch.save``.
    The ranks meet through a ``FileStore`` in a temporary directory (no
    port to collide with).  A rank that raises fails the call with its
    traceback, and the other ranks are ended.  ``threads``: torch's
    thread count in each rank."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="dvt_spawn_") as tmp:
        mp.start_processes(_entry, args=(fn, size, str(device), tmp, args,
                                         threads),
                           nprocs=size, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False) for r in range(size)]


@dataclasses.dataclass
class Group:
    """The ranks of one axis slice of the mesh (global ranks in axis order)
    and this rank's index among them."""
    ranks: tuple
    index: int
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


def new_groups(slices) -> list:
    """One ``Group`` a slice of ``slices`` (tuples of global ranks); every
    rank calls this with the same slices in the same order
    (``torch.distributed.new_group`` is collective).  Returns the groups
    this rank belongs to, in order; a slice of one rank needs no process
    group."""
    mine = []
    for ranks in slices:
        ranks = tuple(ranks)
        if len(ranks) > 1 and ranks not in _GROUPS:
            _GROUPS[ranks] = dist.new_group(list(ranks))
        if WORLD.rank in ranks:
            mine.append(Group(ranks, ranks.index(WORLD.rank),
                              _GROUPS.get(ranks)))
    return mine


def _count(n: int) -> None:
    WORLD.bytes_sent += int(n)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (``t`` itself on the CPU)."""
    if t.device.type == "cpu":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``t`` over the group in place; returns ``t``."""
    g = group.size
    if g == 1:
        return t
    _count(2 * (g - 1) * t.numel() * t.element_size() // g)
    if WORLD.host_staged:
        h = _host(t)
        dist.all_reduce(h, group=group.pg)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group.pg)
    return t


def all_gather(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The group's pieces ``t`` (equal shapes) concatenated along ``dim``,
    in the group's order."""
    g = group.size
    if g == 1:
        return t
    t = t.contiguous()
    _count((g - 1) * t.numel() * t.element_size())
    src = _host(t) if WORLD.host_staged else t
    parts = [torch.empty_like(src) for _ in range(g)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.cat(parts, dim).to(t.device)


def gather_into(target: torch.Tensor, piece: torch.Tensor, group: Group,
                dim: int) -> torch.Tensor:
    """All-gather the group's ``piece`` into ``target``, whose extent along
    ``dim`` is the group's size times the piece's, in place (``target``
    may be a view)."""
    target.copy_(all_gather(piece, group, dim))
    return target


def broadcast(t: torch.Tensor, group: Group, src: int) -> torch.Tensor:
    """``t`` of the group's rank ``src`` (an index in the group), in place
    on every rank of the group."""
    if group.size == 1:
        return t
    if group.index == src:
        _count(t.numel() * t.element_size())
    if WORLD.host_staged:
        h = _host(t)
        dist.broadcast(h, group.ranks[src], group=group.pg)
        t.copy_(h)
    else:
        dist.broadcast(t, group.ranks[src], group=group.pg)
    return t


class _Sent:
    def __init__(self, work, keep):
        self.work, self.keep = work, keep

    def wait(self):
        self.work.wait()
        self.keep = None


def isend(t: torch.Tensor, group: Group, dst: int) -> _Sent:
    """Start sending ``t`` to the group's rank ``dst``; ``.wait()`` on the
    result before ``t`` is written again."""
    t = t.contiguous()
    _count(t.numel() * t.element_size())
    src = _host(t) if WORLD.host_staged else t
    return _Sent(dist.isend(src, group.ranks[dst], group=group.pg), src)


def recv(shape, dtype, device, group: Group, src: int) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` received from the group's rank
    ``src``, on ``device``."""
    dev = torch.device(device)
    staged = WORLD.host_staged and dev.type == "cuda"
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if staged else dev, pin_memory=staged)
    dist.recv(buf, group.ranks[src], group=group.pg)
    return buf.to(dev) if staged else buf


def _local(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    return t.chunk(group.size, dim)[group.index]


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, replicated):
        ctx.group, ctx.dim, ctx.replicated = group, dim, replicated
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if not ctx.replicated:  # reduce-scatter: every rank's consumers
            g = all_reduce(g.contiguous().clone(), ctx.group)
        return _local(g, ctx.group, ctx.dim).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _local(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def enter_parallel(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x``, replicated over the group, entering per-rank consumers (a
    column-parallel product): the gradient is the sum of the ranks'."""
    return x if group.size == 1 else _Enter.apply(x, group)


def reduce_parallel(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of the group's partial ``x`` (a row-parallel product),
    consumed alike on every rank: the gradient passes unchanged."""
    return x if group.size == 1 else _Reduce.apply(x, group)


def gather(x: torch.Tensor, group: Group, dim: int,
           replicated: bool) -> torch.Tensor:
    """The group's pieces ``x`` concatenated along ``dim``.  ``replicated``:
    every rank consumes the result alike, so a rank's gradient is the
    local slice of its own; else the consumers differ per rank and the
    gradient is reduce-scattered (summed over the ranks, then sliced)."""
    return x if group.size == 1 else _Gather.apply(x, group, dim, replicated)


def split(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's even slice of ``x`` (replicated) along ``dim``; the
    gradient is gathered."""
    return x if group.size == 1 else _Split.apply(x, group, dim)
