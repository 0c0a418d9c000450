"""Parallelism over ``torch.distributed`` (counterpart of
``quantizations_tpu/parallel/``).

The JAX package runs one controller and ``shard_map`` over a device mesh.
The port runs one process per rank (:mod:`.launch`), each on its own
shard of the parameters and the cache, with the collectives of
:mod:`.collectives` over the process groups of a :class:`~.mesh.Mesh`:
tensor parallelism (:mod:`.shard`), data x tensor parallelism
(:mod:`.multihost`), pipeline parallelism (:mod:`.pipeline`) and
sequence-parallel ring attention (:mod:`.ring`).
"""

from .launch import RankError, RankPool, launch
from .mesh import Axis, Mesh, make_mesh
from .shard import (
    make_sharded_generate_fn,
    shard_for_rank,
    shard_llama_params,
    sharded_cache,
    validate_tp,
)

__all__ = [
    "Axis",
    "Mesh",
    "make_mesh",
    "launch",
    "RankPool",
    "RankError",
    "validate_tp",
    "shard_for_rank",
    "shard_llama_params",
    "sharded_cache",
    "make_sharded_generate_fn",
]
