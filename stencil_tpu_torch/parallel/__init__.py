from .exchange import (HaloExchange, Method, direction_bytes, join_positions, shard_blocks,
                       split_positions, unshard_blocks)
from .mesh import DeviceMesh

__all__ = ["DeviceMesh", "HaloExchange", "Method", "direction_bytes", "join_positions",
           "shard_blocks", "split_positions", "unshard_blocks"]
