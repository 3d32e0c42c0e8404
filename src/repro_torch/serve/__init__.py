"""The port's request plane: :class:`IndexService` (the LM serving scaffold
of :mod:`repro.serve` is not ported yet)."""
from .service import (
    IndexService,
    OpFuture,
    ScanPage,
    ServiceConfig,
    ServiceStats,
    TENANT_SEP,
)

__all__ = ["IndexService", "OpFuture", "ServiceConfig", "ServiceStats",
           "ScanPage", "TENANT_SEP"]
