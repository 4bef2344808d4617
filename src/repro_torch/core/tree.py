"""Nested-dict trees: the port's stand-in for JAX pytrees of params.

Params, grads, optimizer moments and partition specs are nested dicts
whose leaves are tensors (or, for specs, tuples of axis names).  Leaves
are visited in sorted-key order, which is ``jax.tree.flatten``'s order
for dicts, so bucket layouts match the reference's.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree: Any, prefix: tuple = ()) -> list:
    """[(path tuple of keys, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def get(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def map_with_path(fn: Callable, tree: Any, prefix: tuple = ()) -> Any:
    """A tree of the same structure with ``fn(path, leaf)`` at each
    leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree)


def from_paths(items: list) -> dict:
    """Inverse of :func:`leaves_with_paths`."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
