"""Nested dicts of tensors as the reference's pytrees: leaves in JAX's order
(dict keys sorted at every level) under ``/``-joined paths
(``params/blocks/attn.wq``)."""
from __future__ import annotations

from typing import Callable, Iterator, Tuple


def items(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) of every leaf, in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def map_with_path(fn: Callable, tree, prefix: str = ""):
    """A tree of the same structure holding ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)
