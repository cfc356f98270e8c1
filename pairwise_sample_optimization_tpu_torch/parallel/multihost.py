"""Multi-process bring-up: ``torch.distributed``, one process per card.

The reference scales by ``accelerate launch`` spawning one NCCL process per
GPU; so does the port, under ``torchrun --nproc_per_node=N``. Without a
launch contract in the environment and without a process group, every
function here is a no-op for one process (rank 0 of 1).

Environment contract, read in this order:

- the JAX package's ``PSO_COORDINATOR`` (host:port of process 0),
  ``PSO_NUM_PROCESSES`` and ``PSO_PROCESS_ID``, so one launch script serves
  both packages;
- torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.

``LOCAL_RANK`` (torchrun's; 0 when unset) picks the card of a process
(``device.resolve_device``). The backend is NCCL for a CUDA device and gloo
for the CPU; a caller may ask for gloo with a CUDA device, which lets
several processes share one card (NCCL refuses two ranks on one device).
The group's timeout (``DEFAULT_TIMEOUT_S`` unless the caller gives one)
bounds how long a rank waits for the others, rank 0's validation and
checkpoint writes included.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0


def is_initialized() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the group; 0 without one."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """Processes in the group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK``, else 0."""
    return int(os.environ.get("LOCAL_RANK", 0))


def barrier() -> None:
    """Wait for every rank (nothing to wait for in one process)."""
    if world_size() > 1:
        dist.barrier()


def launch_contract() -> Optional[tuple[str, int, int]]:
    """(init method, rank, world size) from the environment, or None.
    torchrun's variables go through ``env://``, which joins the store that
    torchrun's agent may already hold at ``MASTER_PORT``."""
    env = os.environ
    if env.get("PSO_COORDINATOR"):
        return (f"tcp://{env['PSO_COORDINATOR']}", int(env["PSO_PROCESS_ID"]),
                int(env["PSO_NUM_PROCESSES"]))
    if env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        return "env://", int(env["RANK"]), int(env["WORLD_SIZE"])
    return None


def maybe_initialize_distributed(backend: Optional[str] = None, device=None,
                                 timeout_s: Optional[float] = None) -> bool:
    """Start the process group the environment describes, once. Returns True
    when a group of more than one process is (now) active.

    ``device`` (default: CUDA where available, else the CPU) picks the
    backend unless ``backend`` is given: NCCL for CUDA (the process's card
    becomes the current device), gloo for the CPU. A group that already
    exists is kept as it is, whoever started it."""
    if not is_initialized():
        contract = launch_contract()
        if contract is None:
            return False
        init_method, proc, world = contract
        dev = torch.device(device if device is not None else
                           ("cuda" if torch.cuda.is_available() else "cpu"))
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None else local_rank())
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method, rank=proc, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S))
    return world_size() > 1


def shutdown_distributed() -> None:
    """End the process group, where there is one, and forget the mesh made
    over it."""
    from . import mesh

    mesh.reset_mesh()
    mesh._GROUPS.clear()
    if is_initialized():
        dist.destroy_process_group()
