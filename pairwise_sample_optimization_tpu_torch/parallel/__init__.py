"""Data-parallel, FSDP and tensor-parallel training and evaluation over
``torch.distributed``: one process per card (NCCL), or several processes on
the CPU or on one card (gloo). The counterpart of the JAX package's
``parallel/``: the (data, model) mesh (``mesh.py``), the collectives
(``collectives.py``), FSDP of the frozen weights over ``data``
(``fsdp.py``) and tensor parallelism of the UNet over ``model``
(``tp.py``)."""

from .collectives import (all_gather_dim, all_reduce_mean_, all_reduce_sum_, broadcast_,
                          broadcast_train_state_, copy_to_group, process_allgather,
                          reduce_from_group, round_robin_gather)
from .mesh import (MeshSpec, current_mesh, data_group, data_index, data_size, init_mesh,
                   model_group, model_index, model_size, reset_mesh)
from .multihost import (barrier, local_rank, maybe_initialize_distributed, rank,
                        shutdown_distributed, world_size)
from .prng import host_fold, rank_entropy

__all__ = [
    "MeshSpec",
    "all_gather_dim",
    "all_reduce_mean_",
    "all_reduce_sum_",
    "barrier",
    "broadcast_",
    "broadcast_train_state_",
    "copy_to_group",
    "current_mesh",
    "data_group",
    "data_index",
    "data_size",
    "host_fold",
    "init_mesh",
    "local_rank",
    "maybe_initialize_distributed",
    "model_group",
    "model_index",
    "model_size",
    "process_allgather",
    "rank",
    "rank_entropy",
    "reduce_from_group",
    "reset_mesh",
    "round_robin_gather",
    "shutdown_distributed",
    "world_size",
]
