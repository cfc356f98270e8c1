"""Data-parallel training and evaluation over ``torch.distributed``: one
process per card (NCCL), or several processes on the CPU or on one card
(gloo). The counterpart of the JAX package's ``parallel/`` data axis."""

from .collectives import (all_reduce_mean_, broadcast_, broadcast_train_state_,
                          process_allgather, round_robin_gather)
from .mesh import MeshSpec
from .multihost import (barrier, local_rank, maybe_initialize_distributed, rank,
                        shutdown_distributed, world_size)
from .prng import host_fold, rank_entropy

__all__ = [
    "MeshSpec",
    "all_reduce_mean_",
    "barrier",
    "broadcast_",
    "broadcast_train_state_",
    "host_fold",
    "local_rank",
    "maybe_initialize_distributed",
    "process_allgather",
    "rank",
    "rank_entropy",
    "round_robin_gather",
    "shutdown_distributed",
    "world_size",
]
