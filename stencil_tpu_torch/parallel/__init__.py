from .exchange import HaloExchange, Method, direction_bytes, shard_blocks, unshard_blocks

__all__ = ["HaloExchange", "Method", "direction_bytes", "shard_blocks", "unshard_blocks"]
