"""Serving substrate: the prefill/decode engine, the LITS prompt-prefix cache
and the :class:`IndexService` async multi-tenant request plane."""
from .engine import ServeEngine, ServeStats
from .prefix_cache import PrefixCache, PrefixCacheStats
from .service import (
    IndexService,
    OpFuture,
    ScanPage,
    ServiceConfig,
    ServiceStats,
    TENANT_SEP,
)

__all__ = ["IndexService", "OpFuture", "PrefixCache", "PrefixCacheStats", "ServeEngine",
           "ServeStats", "ServiceConfig", "ServiceStats", "ScanPage", "TENANT_SEP"]
