"""The port of :mod:`repro.distributed`: the distributed index service,
the mesh's logical sharding rules (``sharding``) and int8 gradient
compression for data parallelism (``compression``)."""
from .index_service import (
    DistributedStringIndex,
    RoutedLookup,
    RoutingOverflowError,
    ShardedIndex,
    build_sharded,
    make_service_fn,
)

__all__ = ["DistributedStringIndex", "RoutedLookup", "RoutingOverflowError", "ShardedIndex",
           "build_sharded", "make_service_fn"]
