"""The logical mesh of a run: its ``data`` axis over processes.

Counterpart of the JAX package's ``parallel/mesh.py::MeshSpec``. The port's
mesh is data-parallel only, one process per card: ``data`` must be -1 (all
processes) or the world size. Tensor parallelism (``model > 1``) and FSDP
are refused until they are ported. XLA's placement helpers
(``shard_global_batch``, ``move_to_memory_kind``) have no counterpart:
each rank holds its own rows, and ``utils/offload.py`` moves towers to
host memory.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; ``data * model`` must equal the world size."""

    data: int = -1  # -1: every process
    model: int = 1
    fsdp: bool = False

    def resolve(self, world: int) -> tuple[int, int]:
        """(data, model) over ``world`` processes."""
        if self.model > 1:
            raise NotImplementedError(
                f"mesh.model={self.model}: tensor parallelism (the JAX package's "
                "parallel/tp.py) is not ported yet; it is the next distributed slice")
        if self.fsdp:
            raise NotImplementedError(
                "mesh.fsdp=True: FSDP over the frozen weights (the JAX package's "
                "parallel/fsdp.py) is not ported yet; it is the next distributed slice")
        model = self.model
        data = self.data if self.data != -1 else world // model
        if data * model != world:
            raise ValueError(f"Mesh {data}x{model} does not cover {world} processes")
        return data, model
