"""The logical mesh of a run: a ``data`` axis and a ``model`` axis over the
processes.

Counterpart of the JAX package's ``parallel/mesh.py``. The world of W
processes is laid out as JAX lays out its devices
(``np.asarray(devices).reshape(data, model)``): rank = d * model + m, so
the model ranks of one data index are consecutive. :func:`init_mesh`
makes two kinds of process groups:

- the ``data`` group of a rank: the ranks that share its model index m
  (the gradient all-reduce, the gathers of samples and rewards, the start
  broadcast, FSDP's weight gathers);
- the ``model`` group: the ranks that share its data index d (tensor
  parallelism's activation all-reduces, ``parallel/tp.py``).

With ``model == 1`` the data group is the whole world and everything runs as
plain data parallelism. The accessors (:func:`data_index`,
:func:`data_size`, :func:`model_index`, :func:`model_size`,
:func:`data_group`, :func:`model_group`) give rank / world and no model axis
until a mesh is made. XLA's placement helpers (``shard_global_batch``,
``move_to_memory_kind``) have no counterpart: each rank holds its own rows,
and ``utils/offload.py`` moves towers to host memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from .multihost import is_initialized, rank, world_size


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; ``data * model`` must equal the world size.
    ``fsdp`` shards the frozen weights over ``data`` (``parallel/fsdp.py``);
    it does not combine with ``model > 1``, as in the JAX runner."""

    data: int = -1  # -1: every process left over by ``model``
    model: int = 1
    fsdp: bool = False

    def resolve(self, world: int) -> tuple[int, int]:
        """(data, model) over ``world`` processes."""
        model = self.model
        if model < 1:
            raise ValueError(f"mesh.model={model} must be at least 1")
        data = self.data if self.data != -1 else world // model
        if data * model != world:
            raise ValueError(f"Mesh {data}x{model} does not cover {world} processes")
        if self.fsdp and model > 1:
            raise ValueError("mesh.fsdp combines weight sharding over 'data' with "
                             "mesh.model>1 width sharding -- unsupported; pick one")
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh and its two groups (None:
    the whole world for the data group, no group for the model group)."""

    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Optional[object]
    model_group: Optional[object]
    fsdp: bool = False


_MESH: Optional[Mesh] = None
_GROUPS: dict = {}  # (data, model) -> (data groups, model groups), made once per shape


def _groups(data: int, model: int):
    """Every data group and every model group of a (data, model) layout,
    made by every rank in the same order (``new_group`` is collective)."""
    key = (data, model)
    if key not in _GROUPS:
        data_groups = ([None] if model == 1 else
                       [dist.new_group([d * model + m for d in range(data)])
                        for m in range(model)])
        model_groups = ([None] * data if model == 1 else
                        [dist.new_group([d * model + m for m in range(model)])
                         for d in range(data)])
        _GROUPS[key] = (data_groups, model_groups)
    return _GROUPS[key]


def init_mesh(spec: MeshSpec) -> Mesh:
    """Lay the world out as ``spec`` and make it this process's mesh. Every
    rank calls it with the same spec."""
    global _MESH
    world = world_size()
    data, model = spec.resolve(world)
    r = rank()
    d, m = divmod(r, model)
    if is_initialized() and world > 1:
        data_groups, model_groups = _groups(data, model)
        dg = data_groups[0] if model == 1 else data_groups[m]
        mg = model_groups[d]
    else:
        dg = mg = None
    _MESH = Mesh(data, model, d, m, dg, mg, bool(spec.fsdp))
    return _MESH


def reset_mesh() -> None:
    """Back to no mesh: data parallelism over the whole world."""
    global _MESH
    _MESH = None


def current_mesh() -> Optional[Mesh]:
    return _MESH


def data_index() -> int:
    """This rank's index on the data axis (its rank without a mesh)."""
    return _MESH.data_index if _MESH else rank()


def data_size() -> int:
    """Ranks on the data axis (the world without a mesh)."""
    return _MESH.data if _MESH else world_size()


def model_index() -> int:
    """This rank's index on the model axis (0 without a mesh)."""
    return _MESH.model_index if _MESH else 0


def model_size() -> int:
    """Ranks on the model axis (1 without a mesh)."""
    return _MESH.model if _MESH else 1


def data_group():
    """The process group of this rank's data axis (None: the world)."""
    return _MESH.data_group if _MESH else None


def model_group():
    """The process group of this rank's model axis (None without one)."""
    return _MESH.model_group if _MESH else None
