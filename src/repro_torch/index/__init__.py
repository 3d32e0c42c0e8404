"""The port's application-facing index API: the counterpart of :mod:`repro.index`."""
from .facade import (
    BatchResult,
    MergeTicket,
    DeleteRequest,
    GetRequest,
    IndexConfig,
    OpResult,
    OVERLOADED_RESULT,
    PutRequest,
    Request,
    ScanRequest,
    Status,
    StringIndex,
    StringIndexBase,
)
from .snapshot import (
    SNAPSHOT_MAGIC,
    SNAPSHOT_VERSION,
    SnapshotError,
    SnapshotFormatError,
    SnapshotVersionError,
    load_index,
    save_index,
)

__all__ = [
    "StringIndex", "StringIndexBase", "IndexConfig",
    "GetRequest", "PutRequest", "ScanRequest", "DeleteRequest", "Request",
    "OpResult", "BatchResult", "Status", "OVERLOADED_RESULT", "MergeTicket",
    "save_index", "load_index",
    "SnapshotError", "SnapshotFormatError", "SnapshotVersionError",
    "SNAPSHOT_MAGIC", "SNAPSHOT_VERSION",
]
