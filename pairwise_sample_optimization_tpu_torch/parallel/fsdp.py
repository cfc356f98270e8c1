"""FSDP (ZeRO-3) of the frozen weights over the ``data`` axis.

Counterpart of the JAX package's ``parallel/fsdp.py``. JAX annotates each
frozen leaf of at least ``min_size`` (here :data:`MIN_SIZE`) elements with
a sharding along its largest axis that the data size divides, and GSPMD
inserts the all-gathers where a layer uses the weight. Here each such
parameter keeps only its rank's slice of that axis
(``tensor.chunk(n, dim)[data index]``); a forward pre-hook on the module
that uses it gathers the whole tensor (exact: every rank's bytes,
``collectives.all_gather_dim``) into the module's instance attribute of the
same name, and a forward hook drops it, so the kernels only ever see plain
tensors. A rematerialized block gathers again when it
is recomputed; a gathered weight that autograd saved for the backward
lives until the backward has used it.

The axis is JAX's: a torch ``nn.Linear`` weight (out, in) is a flax kernel
(in, out) and a ``Conv2d`` weight (O, I, H, W) a kernel (H, W, I, O), so
the rule runs on the flax shape and its axis is carried back. LoRA adapters
(the trained ``lora.*`` tensors) are never sharded. ``HostOffload`` moves the
slices as it moves any parameter: an offloaded tower keeps its sharding.

The module whose forward gathers a parameter is the one that owns it,
except for an ``nn.Embedding`` (whose weight its parent reads, as the CLIP
and BERT embeddings do) and the convolution of an ``Upsample`` (which hands
its weights to ``ops.upsample``): those gather around the parent's forward.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .collectives import all_gather_dim, group_rank, group_size

MIN_SIZE = 2**16  # the JAX package's default ``min_size``


def _fsdp_axis(shape: Sequence[int], n: int, min_size: int) -> Optional[int]:
    """The JAX package's ``_fsdp_spec`` rule on a flax shape: the axis a
    leaf is sharded along, or None (replicated)."""
    size = 1
    for s in shape:
        size *= s
    if size < min_size or not shape:
        return None
    for d in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if shape[d] % n == 0:
            return d
    return None


def _flax_axes(owner: nn.Module, name: str, ndim: int) -> Tuple[int, ...]:
    """For each axis of the flax leaf, the torch axis it is."""
    if name == "weight" and isinstance(owner, nn.Linear) and ndim == 2:
        return (1, 0)
    if name == "weight" and isinstance(owner, nn.Conv2d) and ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def fsdp_dim(owner: nn.Module, name: str, shape: Sequence[int], n: int) -> Optional[int]:
    """The torch axis along which ``owner.<name>`` (of torch ``shape``) is
    sharded over ``n`` ranks, or None."""
    axes = _flax_axes(owner, name, len(shape))
    axis = _fsdp_axis([shape[a] for a in axes], n, MIN_SIZE)
    return None if axis is None else axes[axis]


def _units(module: nn.Module) -> Dict[nn.Module, nn.Module]:
    """owner -> the module whose forward gathers the owner's parameters."""
    from ..models.layers import Upsample

    out = {}
    for parent in module.modules():
        for child in parent.children():
            if isinstance(child, nn.Embedding) or (isinstance(parent, Upsample)
                                                   and isinstance(child, nn.Conv2d)):
                out[child] = parent
    return out


def fsdp_plan(module: nn.Module, n: int) -> Dict[str, int]:
    """{parameter name: torch axis} of the parameters of ``module`` that
    FSDP over ``n`` ranks shards."""
    plan = {}
    for owner_name, owner in module.named_modules():
        for name, p in owner.named_parameters(recurse=False):
            full = f"{owner_name}.{name}" if owner_name else name
            if ".lora." in f".{full}":
                continue
            dim = fsdp_dim(owner, name, p.shape, n)
            if dim is not None:
                plan[full] = dim
    return plan


@torch.no_grad()
def shard_module_fsdp(module: nn.Module, group=None) -> nn.Module:
    """Keep this rank's slices of ``module``'s large frozen parameters and
    gather them around the forward of the modules that use them (see the
    module docstring). ``group`` is the data axis; a group of one rank
    leaves the module as it is. Returns ``module``."""
    n, i = group_size(group), group_rank(group)
    if n == 1:
        return module
    units = _units(module)
    plan = fsdp_plan(module, n)
    gathers: Dict[nn.Module, List[tuple]] = {}
    for owner_name, owner in module.named_modules():
        for name, p in list(owner.named_parameters(recurse=False)):
            dim = plan.get(f"{owner_name}.{name}" if owner_name else name)
            if dim is None:
                continue
            p.data = p.data.chunk(n, dim)[i].clone()
            p.fsdp_dim = dim
            gathers.setdefault(units.get(owner, owner), []).append((owner, name, p, dim))
    for unit, entries in gathers.items():
        unit.register_forward_pre_hook(_gather_hook(entries, group))
        unit.register_forward_hook(_release_hook(entries))
    return module


def _gather_hook(entries, group):
    @torch.no_grad()
    def hook(module, args):
        for owner, name, p, dim in entries:
            owner.__dict__[name] = all_gather_dim(p.detach(), dim, group)
    return hook


def _release_hook(entries):
    def hook(module, args, out):
        for owner, name, _, _ in entries:
            owner.__dict__.pop(name, None)
    return hook
