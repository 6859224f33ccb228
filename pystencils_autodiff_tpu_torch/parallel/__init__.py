"""Domain decomposition over a mesh of devices: sharded stencils and
comm-avoiding sharded fused chains with halo exchange — the port of
``pystencils_autodiff_tpu/parallel``.

One process drives every shard of a ``Mesh`` (JAX's single-controller
``shard_map`` model); the mesh's devices may be several cards, or one card
named several times (``make_mesh((4,), ("x",), [torch.device("cuda")] *
4)``).  Running one process per card over ``torch.distributed`` is not
part of this package.
"""

from .chain import ShardedChain
from .halo import (exchange_count, exchange_dim, extend_with_halo,
                   mask_global_ghost, reset_exchange_count)
from .mesh import Mesh, ShardedArray
from .sharding import ShardedStencil, make_mesh, shard_array

__all__ = [
    "exchange_dim",
    "extend_with_halo",
    "mask_global_ghost",
    "ShardedChain",
    "ShardedStencil",
    "make_mesh",
    "shard_array",
    "Mesh",
    "ShardedArray",
    "exchange_count",
    "reset_exchange_count",
]
