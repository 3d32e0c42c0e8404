"""Host builder, HPT, tensor index and walk of the port.

The names below are the port's counterparts of the reference's legacy
free-function surface (:mod:`repro.core`): the builder, the HPT, and the
batched primitives over the frozen :class:`TensorIndex`.  Application code
should prefer :class:`repro_torch.index.StringIndex`, which is built on
exactly these functions.  There is no backend knob: the tensors' device
decides the path (the CUDA kernels on the card, the plain versions on the
CPU).

They resolve on first access: the kernel wrappers import
:mod:`repro_torch.core.walk`, and ``tensor_index`` imports the wrappers, so
importing ``tensor_index`` here eagerly would make that a cycle.
"""
import importlib

_EXPORTS = {
    **dict.fromkeys(("LITSBuilder", "LITSConfig", "TAG_EMPTY", "TAG_ENTRY", "TAG_MNODE",
                     "TAG_CNODE", "TAG_TRIE"), "builder"),
    **dict.fromkeys(("HPT", "build_hpt", "uniform_hpt", "get_cdf", "get_cdf_np64",
                     "positions"), "hpt"),
    **dict.fromkeys(("gpkl", "local_gpkl", "pkl"), "gpkl"),
    **dict.fromkeys(("PMSS", "AlwaysLIT", "AlwaysTrie"), "pmss"),
    **dict.fromkeys(("StringSet", "sort_order"), "strings"),
    **dict.fromkeys(("TensorIndex", "freeze", "search_batch", "base_search", "insert_batch",
                     "delete_batch", "lookup_values", "merge_delta", "pad_queries",
                     "rank_batch", "scan_batch"), "tensor_index"),
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{module}", __name__), name)
