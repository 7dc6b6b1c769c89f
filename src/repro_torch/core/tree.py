"""The port's pytrees: nested dicts, lists and tuples (NamedTuples
included) of tensors, as the params, the optimizer state and the
checkpointed (params, state) pair are.  Dict keys are walked in sorted
order, as ``jax.tree`` walks them."""

from __future__ import annotations

from collections.abc import Callable, Iterator
from typing import Any

__all__ = ["leaves", "leaves_with_paths", "tree_map"]


def leaves_with_paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in walk order; paths join keys and indices
    with '/'."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from leaves_with_paths(child, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure; leaves are visited in walk order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        children = [tree_map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree)]
        if hasattr(tree, "_fields"):                     # NamedTuple
            return type(tree)(*children)
        return type(tree)(children)
    return fn(tree, *rest)
