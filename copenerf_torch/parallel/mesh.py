"""Ray sharding over the ranks (port of ``copenerf_tpu/parallel/mesh.py``).

The JAX package keeps a 1-D ``('data',)`` mesh and puts sharding
constraints on the leading ray axis. The port has one process per card:
each rank takes its contiguous 1/world slice of the leading axis, and
``gather_rays`` puts the slices back together in rank order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def shard_rays(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/``world`` slice of the leading axis,
    which must divide by ``world``."""
    n = x.shape[0]
    if n % world:
        raise ValueError(f"{n} rays do not split over {world} ranks")
    size = n // world
    return x[rank * size:(rank + 1) * size]


def gather_rays(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order along the leading axis
    (the same shape on every rank); ``x`` itself with no group."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)
