"""Tensor parallelism of the UNet's attention and GEGLU feed-forward over
the ``model`` axis (Megatron-style width sharding).

Counterpart of the JAX package's ``parallel/tp.py``, whose rules
(``_spec_for``, ``_lora_spec_for``) this follows, in torch's (out, in)
layout:

- ``to_q`` / ``to_k`` / ``to_v``: column-parallel (weight dim 0, and a bias
  with it); their LoRA ``down`` replicated, ``up`` column-sharded. ``down``
  reads the attention's input after the one ``copy_to_group``, so each
  rank's gradient of it is the share of its own ``up`` columns, summed by
  :func:`sum_partial_grads_` as ``B``'s below;
- ``to_out.0``: row-parallel (weight dim 1); the bias replicated and added
  once after the sum; LoRA ``down`` row-sharded, ``up`` replicated. One
  all-reduce sums ``x_l W_l^T + s (x_l A_l) B``, so each rank's gradient of
  ``B`` is its share: :func:`sum_partial_grads_` sums them over the model
  group before the update;
- GEGLU ``ff.net.0.proj``: column-parallel over the inner width, each rank
  holding its slice of both halves (hidden and gate), so that the layer's
  ``chunk(2)`` still pairs them; ``ff.net.2``: row-parallel.

Instead of DTensors, each rank's modules hold plain local slices (a CUDA
kernel never sees anything else): an ``Attention`` runs its local heads
(``heads`` is set to their count), an attention or feed-forward puts
``copy_to_group`` once on its input (and context) for all its column layers
and row layers put ``reduce_from_group`` on their output
(``models/layers.py``): per transformer block three all-reduces forward
and, backward, one per input that needs a gradient. Heads are split whole
and as evenly as they go (SDXL's 10 heads over 4 ranks: 3, 3, 2, 2), the
GEGLU inner width the same way; JAX splits widths the same even way where
they divide. Every other
tensor (convs, norms, embeddings, the VAE, the text towers, the scorer) is
replicated and gets the same gradient on every model rank.

Dynamic int8 (the reference pass's ``train.int8_ref_pass``) quantizes per
token and per output row: a column layer has the whole contracted dim and
quantizes as one process does; a row layer (``to_out.0``, ``ff.net.2``) has
a slice of it, so it reduces both absmaxes with max over the model group
before it quantizes (``layers.TensorParallel.int8_product``), as GSPMD
reduces JAX's ``jnp.max`` over the sharded axis, and sums its fp32 partials.

Each sliced parameter carries a :class:`Shard` (``param.tp_shard``): the
whole tensor's shape, the dim and this rank's positions along it. The
optimizers read it for the global norm and the 8-bit moments' blocks
(``train/``). :func:`whole_tensors` and ``train/sharded_state.py``'s
``whole_optimizer_state`` gather whole tensors for checkpoints and LoRA
files, which therefore hold what one process writes; :func:`local_tensors`
and ``load_whole_optimizer_state`` take a rank's slices back out of them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .collectives import all_gather_dim


def split_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each of ``parts`` near-equal runs of ``n`` units, the
    larger first (10 over 4: 3, 3, 2, 2)."""
    out, lo = [], 0
    for i in range(parts):
        hi = lo + n // parts + (1 if i < n % parts else 0)
        out.append((lo, hi))
        lo = hi
    return out


@dataclasses.dataclass(eq=False)
class Shard:
    """A model rank's slice of a whole tensor: ``positions[rank]`` along
    ``dim`` of ``shape``, for every rank of ``group``."""

    shape: Tuple[int, ...]
    dim: int
    positions: Tuple[torch.Tensor, ...]  # per model rank, CPU int64
    rank: int
    group: object

    @property
    def index(self) -> torch.Tensor:
        return self.positions[self.rank]

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole tensor (a contiguous copy)."""
        return whole.index_select(self.dim, self.index.to(whole.device)).contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slice (collective, exact)."""
        sizes = [len(p) for p in self.positions]
        joined = all_gather_dim(local.contiguous(), self.dim, self.group, sizes)
        order = torch.cat(self.positions).to(local.device)
        whole = torch.empty(self.shape, dtype=local.dtype, device=local.device)
        return whole.index_copy_(self.dim, order, joined)

    def flat_index(self) -> torch.Tensor:
        """Each local element's index in the whole tensor's flattened order
        (int64, the local tensor's row-major order)."""
        idx = torch.zeros((), dtype=torch.long)
        stride = 1
        for d in reversed(range(len(self.shape))):
            pos = self.index if d == self.dim else torch.arange(self.shape[d])
            view = [1] * len(self.shape)
            view[d] = -1
            idx = idx + pos.view(view) * stride
            stride *= self.shape[d]
        return idx.reshape(-1)


def shard_of(p) -> Optional[Shard]:
    return getattr(p, "tp_shard", None)


def _slice_(p: nn.Parameter, dim: int, positions: Sequence[torch.Tensor], rank: int, group):
    shard = Shard(tuple(p.shape), dim, tuple(positions), rank, group)
    p.data = shard.take(p.data)
    p.tp_shard = shard


def _heads_positions(heads: int, head_dim: int, parts: int):
    return [torch.arange(lo * head_dim, hi * head_dim) for lo, hi in split_bounds(heads, parts)]


def _geglu_positions(inner: int, parts: int):
    return [torch.cat([torch.arange(lo, hi), inner + torch.arange(lo, hi)])
            for lo, hi in split_bounds(inner, parts)]


def _set_mode(lin, mode: str, group):
    lin.tp_mode, lin.tp_group = mode, group


@torch.no_grad()
def shard_unet_tp(unet: nn.Module, rank: int, size: int, group) -> nn.Module:
    """Slice ``unet``'s attention and feed-forward weights (and their LoRA
    adapters) to model rank ``rank`` of ``size`` in place, and switch their
    layers to the parallel forward over ``group``. Returns ``unet``."""
    from ..models.layers import Attention, GEGLUFeedForward

    if size == 1:
        return unet
    for m in unet.modules():
        if isinstance(m, Attention):
            pos = _heads_positions(m.heads, m.head_dim, size)
            for lin in (m.to_q, m.to_k, m.to_v):
                _col(lin, pos, rank, group)
            _row(m.to_out[0], pos, rank, group)
            m.heads = len(pos[rank]) // m.head_dim
            _set_mode(m, "in", group)
        elif isinstance(m, GEGLUFeedForward):
            _set_mode(m, "in", group)
            proj, out = m.net[0].proj, m.net[2]
            inner = proj.out_features // 2
            _col(proj, _geglu_positions(inner, size), rank, group)
            _row(out, [torch.arange(lo, hi) for lo, hi in split_bounds(inner, size)], rank,
                 group)
    return unet


def _col(lin, pos, rank, group):
    _refuse_dora(lin)
    _slice_(lin.weight, 0, pos, rank, group)
    if lin.bias is not None:
        _slice_(lin.bias, 0, pos, rank, group)
    if getattr(lin, "lora_rank", 0):
        _slice_(lin.lora.up.weight, 0, pos, rank, group)
        lin.lora.down.weight.tp_partial_grad = group
    lin.out_features = len(pos[rank])
    _set_mode(lin, "col", group)


def _row(lin, pos, rank, group):
    _refuse_dora(lin)
    _slice_(lin.weight, 1, pos, rank, group)
    if getattr(lin, "lora_rank", 0):
        _slice_(lin.lora.down.weight, 1, pos, rank, group)
        lin.lora.up.weight.tp_partial_grad = group
    lin.in_features = len(pos[rank])
    _set_mode(lin, "row", group)


def _refuse_dora(lin):
    if getattr(lin, "use_dora", False):
        raise NotImplementedError("DoRA under tensor parallelism: the magnitude normalizes "
                                  "whole rows of the weight")


def sum_partial_grads_(params: Mapping[str, torch.Tensor],
                       grads: Mapping[str, torch.Tensor]) -> None:
    """Sum, in place over the model group, the gradients of the replicated
    tensors whose gradient each rank holds only a share of (a column
    layer's LoRA ``down``, a row layer's LoRA ``up``)."""
    from .collectives import all_reduce_sum_

    parts = [(grads[k], p.tp_partial_grad) for k, p in params.items()
             if getattr(p, "tp_partial_grad", None) is not None]
    if parts:
        all_reduce_sum_([g for g, _ in parts], parts[0][1])


def tp_plan(unet: nn.Module) -> Dict[str, int]:
    """{parameter name: torch dim} of a sliced UNet's sharded parameters."""
    return {name: p.tp_shard.dim for name, p in unet.named_parameters() if shard_of(p)}


# ---------------------------------------------------------------------- #
# whole tensors for checkpoints and LoRA files, and back
# ---------------------------------------------------------------------- #


def whole_tensors(named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{name: whole tensor}: sharded parameters gathered over their model
    group (a collective every model rank makes), the others as they are."""
    out = {}
    for k, p in named.items():
        s = shard_of(p)
        out[k] = s.gather(p.detach()) if s is not None else p.detach()
    return out


def local_tensors(named: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor]):
    """This rank's slices of whole tensors ``named`` for ``params``'
    shards."""
    out = {}
    for k, v in named.items():
        s = shard_of(params[k]) if k in params else None
        out[k] = s.take(v) if s is not None else v
    return out


def is_sharded(params) -> bool:
    """Whether any of ``params`` is a tensor-parallel slice."""
    return any(shard_of(p) is not None for p in params)
