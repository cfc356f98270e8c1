"""Collectives of data-parallel training and evaluation.

Counterparts of the JAX package's ``parallel/collectives.py``:

- the DDP gradient all-reduce (``pmean_tree`` inside the JAX train step)
  -> :func:`all_reduce_mean_`, in place over buckets of gradients;
- ``process_allgather`` / ``round_robin_gather`` (the reference's
  ``accelerator.gather``) -> the same names here, on tensors or numpy
  arrays;
- the replicated start of JAX's mesh -> :func:`broadcast_` and
  :func:`broadcast_train_state_` from rank 0.

Everything is built on ``all_reduce`` and ``broadcast`` alone, so it runs
unchanged on NCCL and on gloo, on the card and on the CPU (gloo has no
all-gather of CUDA tensors and no ``ReduceOp.AVG``). The all-gather sums
a zeroed ``(world, ...)`` buffer into which each rank wrote its own row,
as bytes: 0 + b = b, so every rank receives each row bit for bit. The
mean sums and divides by the world size.

Each function takes a ``group`` (default None: the whole world), such as
a mesh axis of ``parallel/mesh.py``; rank 0 of a broadcast is the group's
first rank. Tensor parallelism's two operators, :func:`copy_to_group`
(identity forward, all-reduce backward) and :func:`reduce_from_group`
(all-reduce forward, identity backward), and :func:`all_gather_dim` (the
weight gather of FSDP and of whole-tensor checkpoints) live here too.

Without a process group every function returns at once (a gather returns
``x[None]``), so code is the same at any world size; a group of one
process runs the collectives (NCCL or gloo on their own), a mesh group of
one rank runs none.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .multihost import is_initialized, rank, world_size

# bytes of gradients one all-reduce carries: tensors smaller than this are
# packed into a shared buffer of at most this size; larger ones go alone
BUCKET_BYTES = 64 << 20


def group_size(group=None) -> int:
    """Ranks in ``group`` (None: the world; 1 without a process group)."""
    if not is_initialized():
        return 1
    return dist.get_world_size(group) if group is not None else world_size()


def group_rank(group=None) -> int:
    """This rank's index in ``group`` (None: the world)."""
    if not is_initialized():
        return 0
    return dist.get_rank(group) if group is not None else rank()


def _active(group) -> bool:
    """Whether a collective over ``group`` has work: a group of several
    ranks, or the world's group even of one process (NCCL and gloo run on
    their own there)."""
    return is_initialized() and (group is None or dist.get_world_size(group) > 1)


def _comm_device() -> torch.device:
    """Where a host array goes to be communicated: NCCL needs the card."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _buckets(tensors: Sequence[torch.Tensor]):
    """Runs of ``tensors`` of one device and dtype, each run at most
    ``BUCKET_BYTES`` unless it is a single tensor."""
    run, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.device != run[0].device or t.dtype != run[0].dtype
                    or size + nbytes > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


def _bucketed_(tensors: Iterable[torch.Tensor], op) -> None:
    """Apply the in-place collective ``op`` to every tensor, packing small
    tensors into one flat buffer per bucket and unpacking after."""
    for run in _buckets([t for t in tensors if t.numel()]):
        if len(run) == 1 and run[0].is_contiguous():
            op(run[0])
            continue
        flat = torch.cat([t.reshape(-1) for t in run])
        op(flat)
        offset = 0
        for t in run:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks of ``group``, in
    place. The ranks pass their tensors in the same order; every rank ends
    with the same values. No flat copy of all of them is made: a bucket
    holds at most ``BUCKET_BYTES``."""
    if not _active(group):
        return
    world = group_size(group)

    def reduce(t):
        dist.all_reduce(t, group=group)
        t.div_(world)

    _bucketed_(tensors, reduce)


@torch.no_grad()
def all_reduce_sum_(tensors: Iterable[torch.Tensor], group=None, op=dist.ReduceOp.SUM) -> None:
    """Replace each tensor by its sum (or ``op``: MAX) over the ranks of
    ``group``, in place."""
    if not _active(group):
        return
    _bucketed_(tensors, lambda t: dist.all_reduce(t, op=op, group=group))


def _src(group) -> int:
    """The global rank of ``group``'s first rank."""
    return 0 if group is None else dist.get_global_rank(group, 0)


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Overwrite each tensor with that of ``group``'s first rank, in place."""
    if not _active(group):
        return
    src = _src(group)
    _bucketed_(tensors, lambda t: dist.broadcast(t, src, group=group))


def _tensors_and_numbers(tree, tensors: List[torch.Tensor], numbers: list, path=()):
    """Collect the tensors and the plain numbers of a nested dict / list."""
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
    elif isinstance(tree, dict):
        for k in tree:
            _tensors_and_numbers(tree[k], tensors, numbers, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _tensors_and_numbers(v, tensors, numbers, path + (i,))
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        numbers.append(path)


def _get_path(tree, path):
    for key in path:
        tree = tree[key]
    return float(tree)


def _set_path(tree, path, value):
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = type(tree[path[-1]])(value)


@torch.no_grad()
def broadcast_train_state_(state, group=None) -> None:
    """Make every rank's train state that of ``group``'s first rank (rank 0
    of the world by default): the trained tensors, the update count and the
    optimizer's state (its tensors in place, its numbers through
    ``load_state_dict``). Under tensor parallelism the group is the data
    axis: the ranks that hold the same shards."""
    if not _active(group):
        return
    opt = state.tx.state_dict()
    tensors, numbers = list(state.lora.values()), []
    _tensors_and_numbers(opt, tensors, numbers)
    broadcast_(tensors, group)
    dev = _comm_device()
    values = torch.tensor([float(state.step)] + [_get_path(opt, p) for p in numbers],
                          dtype=torch.float64, device=dev)
    dist.broadcast(values, _src(group), group=group)
    values = values.tolist()
    state.step = int(values[0])
    for path, v in zip(numbers, values[1:]):
        _set_path(opt, path, v)
    state.tx.load_state_dict(opt)


def process_allgather(x, group=None):
    """This rank's ``x`` (n, ...) -> (ranks of ``group``, n, ...) in rank
    order, every rank's bit for bit. A tensor stays on its device (every
    rank passes the same shape and dtype); a numpy array returns as one."""
    is_np = not isinstance(x, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(x)) if is_np else x
    if not _active(group):
        out = t[None]
    else:
        dev = _comm_device() if is_np else t.device
        out = torch.zeros((group_size(group),) + tuple(t.shape), dtype=t.dtype, device=dev)
        out[group_rank(group)].copy_(t)
        if out.numel():
            dist.all_reduce(out.view(-1).view(torch.uint8), group=group)
    return out.cpu().numpy() if is_np else out


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """(ranks, *t.shape): every rank's ``t``, bit for bit. NCCL gathers
    into one buffer; gloo sums bytes into a zeroed one
    (:func:`process_allgather`: gloo has no all-gather of CUDA tensors)."""
    if dist.get_backend(group) == "nccl":
        out = torch.empty((group_size(group),) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out
    return process_allgather(t.contiguous(), group)


@torch.no_grad()
def all_gather_dim(t: torch.Tensor, dim: int, group=None, sizes: Sequence[int] = ()):
    """The ranks' ``t`` joined along ``dim`` in rank order, exact. ``sizes``
    gives each rank's extent along ``dim`` where they differ (every rank
    passes the same list; the shorter ones are padded for the collective
    and cut after)."""
    if not _active(group):
        return t
    n = group_size(group)
    if not sizes or len(set(sizes)) == 1:
        rows = _gather_rows(t, group)
        return torch.cat(rows.unbind(0), dim) if dim else rows.reshape((-1,) + t.shape[1:])
    pad = max(sizes) - t.shape[dim]
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t = torch.cat([t, t.new_zeros(shape)], dim)
    rows = _gather_rows(t, group)
    return torch.cat([rows[i].narrow(dim, 0, sizes[i]) for i in range(n)], dim)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``x`` summed over ``group``, in fp32 for a 16-bit
    ``x`` (one rounding to its dtype at the end)."""
    wide = x.to(torch.float32 if x.element_size() < 4 else x.dtype,
                memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(wide, group=group)
    return wide.to(x.dtype)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: the input of a column-parallel product. Forward
    ``x`` itself; backward the sum of the ranks' gradients, so that
    everything before it sees the whole gradient."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: the output of a row-parallel product. Forward the
    sum of the ranks' partial ``x``; backward the gradient itself."""
    return _ReduceFromGroup.apply(x, group)


def round_robin_gather(local: np.ndarray, total: int) -> np.ndarray:
    """Gather of round-robin shards (``items[rank::world]``, padded to one
    length) back into dataset order: item ``pos`` of rank ``r`` is index
    ``pos * world + r``; pads land past ``total`` and are dropped."""
    stacked = process_allgather(local)  # (world, per, ...)
    return np.moveaxis(stacked, 0, 1).reshape((-1,) + stacked.shape[2:])[:total]

