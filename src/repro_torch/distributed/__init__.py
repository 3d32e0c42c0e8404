"""The port's distributed index service (the LM scaffold's mesh rules and
gradient compression of :mod:`repro.distributed` are not ported yet)."""
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
