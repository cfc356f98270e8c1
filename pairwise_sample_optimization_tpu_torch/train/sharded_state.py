"""Optimizer states of a tensor-parallel rank as one process holds them.

A rank whose trained tensors include tensor-parallel slices
(``parallel.tp``) keeps their moments as slices too (and, for the 8-bit
AdamW, their whole tensors' block scales). Checkpoints hold what a
one-process optimizer over the whole tensors holds, so that a run resumes
at any ``mesh.model``: :func:`whole_optimizer_state` gathers it (a
collective every model rank makes), :func:`load_whole_optimizer_state`
takes this rank's slices out of it. Without slices they are the
optimizer's own ``state_dict`` / ``load_state_dict``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..parallel.tp import is_sharded, shard_of
from .flat_optim import FlatAdamW
from .foreach_adamw import ForeachAdamW, chunk_groups
from .quantized_adam import BLOCK, Adam8bit, ForeachAdam8bit, _blocks, _global_blocks

_FP = ("mu", "nu")
_Q = (("mu_q", "mu_scale", "mu_gscale"), ("nu_q", "nu_scale", "nu_gscale"))


def _whole_shape(p):
    s = shard_of(p)
    return tuple(s.shape) if s is not None else tuple(p.shape)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _slots(tx) -> List[dict]:
    """Per tensor, where its state lives: {"fp": {name: view in its
    shape}} or {"q": {name: int8 stretch}, "scale": {name: view}} (a sliced
    tensor's scales: its stretch of the whole-tensor scales)."""
    out = []
    if isinstance(tx, (FlatAdamW, ForeachAdamW)):
        mu, nu = ((tx._views(tx.mu), tx._views(tx.nu)) if isinstance(tx, FlatAdamW)
                  else (tx.mu, tx.nu))
        return [{"fp": {"mu": m, "nu": n}} for m, n in zip(mu, nu)]
    if isinstance(tx, Adam8bit):
        places = [(None, o) for o in tx.offsets]
        stretches = [tx.stretches]
    else:
        places = [None] * len(tx.params)
        for c, (idx, *_) in enumerate(tx.chunks):
            start = 0
            for i in idx:
                places[i] = (c, start)
                start += _blocks(tx.params[i]) * BLOCK
        stretches = tx.stretches
    gbase = [dict() for _ in stretches]  # chunk -> {start: offset into its gscale}
    for c, st in enumerate(stretches):
        base = 0
        for start, sh in st:
            gbase[c][start] = (base, _global_blocks(sh))
            base += _global_blocks(sh)
    for i, p in enumerate(tx.params):
        c, start = places[i]
        pick = (lambda name: getattr(tx, name)) if c is None else (
            lambda name: getattr(tx, name)[c])
        ci = 0 if c is None else c
        slot = {"q": {}, "scale": {}}
        for qn, sn, gn in _Q:
            slot["q"][qn] = pick(qn).view(-1)[start:start + p.numel()]
            if shard_of(p) is not None:
                b, n = gbase[ci][start]
                slot["scale"][sn] = pick(gn)[b:b + n]
            else:
                b = start // BLOCK
                slot["scale"][sn] = pick(sn)[b:b + _blocks(p)]
        out.append(slot)
    return out


def whole_optimizer_state(tx) -> dict:
    """The ``state_dict`` of a one-process ``tx`` over the whole tensors
    (collective over the model group where ``tx`` holds slices)."""
    if not is_sharded(tx.params):
        return tx.state_dict()
    per = []
    for p, slot in zip(tx.params, _slots(tx)):
        s = shard_of(p)
        if "fp" in slot:
            per.append({k: (s.gather(v) if s is not None else v).detach().clone()
                        for k, v in slot["fp"].items()})
            continue
        entry = {}
        for (qn, sn, _) in _Q:
            q = slot["q"][qn].view(p.shape)
            q = (s.gather(q) if s is not None else q).reshape(-1)
            entry[qn] = F.pad(q, (0, -q.numel() % BLOCK)).view(-1, BLOCK)
            entry[sn] = slot["scale"][sn].clone()
        per.append(entry)
    state: Dict[str, object]
    if isinstance(tx, FlatAdamW):
        state = {k: torch.cat([e[k].reshape(-1) for e in per]) for k in _FP}
    elif isinstance(tx, ForeachAdamW):
        state = {k: [e[k] for e in per] for k in _FP}
    elif isinstance(tx, Adam8bit):
        state = {k: torch.cat([e[k] for e in per]) for k in Adam8bit.state_names}
    else:
        chunks = _whole_chunks(tx)
        state = {k: [torch.cat([per[i][k] for i in idx]) for idx in chunks]
                 for k in ForeachAdam8bit.state_names}
    return {"kind": type(tx).__name__, "count": tx.count, "names": list(tx.names),
            "state": state}


def _whole_chunks(tx: ForeachAdam8bit) -> List[List[int]]:
    """The tensor indices of each chunk a one-process ``tx`` would keep."""
    groups, schedule, chunk = tx.layout
    by_name = dict(zip(tx.names, tx.params))
    whole = [{"params": {n: torch.empty(_whole_shape(by_name[n]), device="meta") for n in names},
              "lr": lr, "weight_decay": wd, "schedule": sch} for names, lr, wd, sch in groups]
    return [idx for idx, *_ in chunk_groups(whole, schedule, chunk, BLOCK)[2]]


@torch.no_grad()
def load_whole_optimizer_state(tx, state: dict) -> None:
    """Load a one-process ``state_dict`` over the whole tensors into ``tx``,
    this rank's slices of it where ``tx`` holds slices."""
    if not is_sharded(tx.params):
        return tx.load_state_dict(state)
    if state.get("kind") != type(tx).__name__ or state.get("names") != tx.names:
        raise KeyError(f"optimizer state of {state.get('kind')!r} over other tensors does "
                       f"not fit this {type(tx).__name__}")
    st = state["state"]
    shapes = [_whole_shape(p) for p in tx.params]
    per = [dict() for _ in tx.params]
    if isinstance(tx, (FlatAdamW, ForeachAdamW)):
        for k in _FP:
            parts = (st[k] if isinstance(tx, ForeachAdamW) else
                     torch.split(st[k], [_numel(s) for s in shapes]))
            for e, v, shape in zip(per, parts, shapes):
                e[k] = v.reshape(shape)
    else:
        chunks = ([list(range(len(shapes)))] if isinstance(tx, Adam8bit) else _whole_chunks(tx))
        for c, idx in enumerate(chunks):
            sizes = [-(-_numel(shapes[i]) // BLOCK) for i in idx]
            for qn, sn, _ in _Q:
                qs = st[qn] if isinstance(tx, Adam8bit) else st[qn][c]
                ss = st[sn] if isinstance(tx, Adam8bit) else st[sn][c]
                for i, q, s in zip(idx, torch.split(qs, sizes), torch.split(ss, sizes)):
                    per[i][qn] = q.reshape(-1)[:_numel(shapes[i])].reshape(shapes[i])
                    per[i][sn] = s
    for p, slot, e in zip(tx.params, _slots(tx), per):
        s = shard_of(p)
        take = (lambda v: s.take(v.to(p.device))) if s is not None else (lambda v: v)
        if "fp" in slot:
            for k, view in slot["fp"].items():
                view.copy_(take(e[k]))
            continue
        for qn, sn, _ in _Q:
            slot["q"][qn].copy_(take(e[qn]).reshape(-1))
            slot["scale"][sn].copy_(e[sn])
    tx.count = int(state["count"])
