"""Nested parameter trees (dicts and lists of tensors), walked in the
reference's order.

JAX flattens a dict by its sorted keys and a list by position; the
optimizer and the checkpoint walk the port's trees the same way, so a
leaf's name (``params/layers/attn/wq/w``, ``#i`` for the i-th list item)
and its place among the leaves are the reference's.
"""
from __future__ import annotations

from typing import Any, Callable

_END = object()


def named_leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """[(name, leaf)] in the reference's flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += named_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += named_leaves(v, f"{prefix}/#{i}" if prefix else f"#{i}")
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a new tree of that
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(template: Any, values: list) -> Any:
    """The structure of ``template`` with its leaves replaced, in
    ``named_leaves`` order, by ``values``."""
    it = iter(values)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    out = walk(template)
    if next(it, _END) is not _END:
        raise ValueError("more values than the template has leaves")
    return out
