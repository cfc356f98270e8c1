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

Without a process group every function returns at once (a gather returns
``x[None]``), so code is the same at any world size; a group of one
process runs the collectives (NCCL or gloo on their own).
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
def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place. The ranks
    pass their tensors in the same order; every rank ends with the same
    values. No flat copy of all of them is made: a bucket holds at most
    ``BUCKET_BYTES``."""
    if not is_initialized():
        return
    world = world_size()

    def reduce(t):
        dist.all_reduce(t)
        t.div_(world)

    _bucketed_(tensors, reduce)


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite each tensor with rank 0's, in place."""
    if not is_initialized():
        return
    _bucketed_(tensors, lambda t: dist.broadcast(t, 0))


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
def broadcast_train_state_(state) -> None:
    """Make every rank's train state rank 0's: the trained tensors,
    the update count and the optimizer's state (its tensors in place, its
    numbers through ``load_state_dict``)."""
    if not is_initialized():
        return
    opt = state.tx.state_dict()
    tensors, numbers = list(state.lora.values()), []
    _tensors_and_numbers(opt, tensors, numbers)
    broadcast_(tensors)
    dev = _comm_device()
    values = torch.tensor([float(state.step)] + [_get_path(opt, p) for p in numbers],
                          dtype=torch.float64, device=dev)
    dist.broadcast(values, 0)
    values = values.tolist()
    state.step = int(values[0])
    for path, v in zip(numbers, values[1:]):
        _set_path(opt, path, v)
    state.tx.load_state_dict(opt)


def process_allgather(x):
    """This rank's ``x`` (n, ...) -> (world, n, ...) in rank order, every
    rank's bit for bit. A tensor stays on its device (every rank passes the
    same shape and dtype); a numpy array returns as one."""
    is_np = not isinstance(x, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(x)) if is_np else x
    world = world_size()
    if not is_initialized():
        out = t[None]
    else:
        dev = _comm_device() if is_np else t.device
        out = torch.zeros((world,) + tuple(t.shape), dtype=t.dtype, device=dev)
        out[rank()].copy_(t)
        if out.numel():
            dist.all_reduce(out.view(-1).view(torch.uint8))
    return out.cpu().numpy() if is_np else out


def round_robin_gather(local: np.ndarray, total: int) -> np.ndarray:
    """Gather of round-robin shards (``items[rank::world]``, padded to one
    length) back into dataset order: item ``pos`` of rank ``r`` is index
    ``pos * world + r``; pads land past ``total`` and are dropped."""
    stacked = process_allgather(local)  # (world, per, ...)
    return np.moveaxis(stacked, 0, 1).reshape((-1,) + stacked.shape[2:])[:total]

