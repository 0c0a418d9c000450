"""Process-group bring-up and data x tensor parallel meshes (counterpart
of ``quantizations_tpu/parallel/multihost.py``).

The JAX package starts ``jax.distributed`` and then runs one program over
every device of every host. Here each rank is a process: under
``torchrun`` (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``) :func:`initialize` joins the group,
and :func:`make_dp_tp_mesh` lays the ranks out with tp as the minor axis,
so that a tp group is ranks of one host whenever a host holds a multiple
of tp ranks.

    from quantizations_tpu_torch.parallel import multihost, shard
    multihost.initialize()               # no-op in a single process
    mesh = multihost.make_dp_tp_mesh(tp=8)
    params = shard.shard_llama_params(full_params, mesh, cfg)
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist

from ..config import ServeConfig
from ..models.llama import LlamaConfig
from .collectives import all_gather_cat
from .mesh import DEFAULT_TIMEOUT, Mesh, choose_backend, make_mesh, rank_device

__all__ = ["initialize", "is_multihost", "host_local_batch",
           "make_dp_tp_mesh", "make_dp_tp_generate_fn", "replica_generator"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Union[str, torch.device] = "cuda") -> None:
    """Join the process group: ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id``, else torchrun's environment
    (``env://``). A single process (no coordinator, a world of 1) returns
    at once, and so does a second call. The backend follows
    :func:`~.mesh.choose_backend` for ``LOCAL_WORLD_SIZE`` ranks on this
    host; each rank's card is :func:`~.mesh.rank_device`."""
    if dist.is_initialized():
        return
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world <= 1 and coordinator_address is None:
        return
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(choose_backend(dev, local), init_method=init,
                            world_size=world, rank=rank,
                            timeout=DEFAULT_TIMEOUT)


def is_multihost() -> bool:
    """More than one process in the group (the JAX package's
    ``process_count() > 1``)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def host_local_batch(global_batch: int) -> int:
    """This process's share of a global batch (data-parallel serving)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} % hosts {n} != 0")
    return global_batch // n


def make_dp_tp_mesh(tp: int, dp: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda") -> Mesh:
    """A ``("dp", "tp")`` mesh over every rank, tp the minor axis: its
    collectives (the per-layer sums and the logits gather) stay among
    neighbouring ranks, while dp is touched only by the data split."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp({dp}) x tp({tp}) != device count {world}")
    return make_mesh((dp, tp), ("dp", "tp"), device=device)


def replica_generator(generator: Optional[torch.Generator], replica: int,
                      device: torch.device) -> Optional[torch.Generator]:
    """A generator of its own for data-parallel replica ``replica``,
    seeded from ``generator``'s seed and the replica index (the JAX
    package folds the dp index into its key): replicas given the same
    prompt then sample differently at temperature > 0."""
    if generator is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed((generator.initial_seed() * 1_000_003 + replica)
                  % (1 << 63))
    return g


def make_dp_tp_generate_fn(cfg: LlamaConfig, serve: ServeConfig,
                           mesh: Mesh) -> Callable:
    """The generate loop over a ``("dp", "tp")`` mesh: ``(params,
    prompt_ids, cache, generator) -> (tokens, cache)``. ``prompt_ids
    [B, P]`` is the global batch on every rank (B divisible by dp); each
    dp replica takes its ``B / dp`` rows and decodes them with tensor
    parallelism (``params`` the rank's tp shard,
    ``shard.shard_llama_params``; ``cache`` its ``[L, B/dp, KV/tp, S,
    D]``, ``shard.sharded_cache(cfg, B // dp, ...)``), sampling from
    :func:`replica_generator`. The replicas need no per-token collective;
    the tokens of every replica are gathered at the end, so every rank
    returns the global ``[B, max_new_tokens]``."""
    from ..serve.generate import make_generate_fn
    from .shard import AXIS, check_mesh, validate_tp

    check_mesh(mesh, ("dp", AXIS))
    validate_tp(cfg, mesh.shape[AXIS])
    dp = mesh.axis("dp")
    gen = make_generate_fn(cfg, serve, axis_name=mesh.axis(AXIS))

    def run(params, prompt_ids, cache, generator=None):
        B = prompt_ids.shape[0]
        if B % dp.size:
            raise ValueError(f"batch {B} % dp {dp.size} != 0")
        rows = B // dp.size
        local = prompt_ids[dp.rank * rows:(dp.rank + 1) * rows]
        toks, cache = gen(params, local, cache, replica_generator(
            generator, dp.rank, prompt_ids.device))
        return all_gather_cat(toks, dp, dim=0), cache

    return run
