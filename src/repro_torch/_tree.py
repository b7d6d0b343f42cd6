"""The few pytree operations the port needs on nested dicts, lists, tuples
and NamedTuples of tensors (its parameters, optimizer and compression
states).

Leaves come in JAX's order (dict keys sorted), and ``keyed_leaves``
names each one by its ``jax.tree_util.keystr`` path (``['runs'][0]['wq']``,
``.error``), so a checkpoint or a bridge keys a leaf as the JAX package
does.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["keyed_leaves", "tree_leaves", "tree_map", "tree_unflatten"]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """[(key string, child), ...] of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def keyed_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr path, leaf), ...] in JAX's flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in kids:
        out.extend(keyed_leaves(child, prefix + key))
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in keyed_leaves(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, c, *(r[i] for r in rest))
                          for i, c in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` (in the order
    ``tree_leaves(template)`` gives)."""
    keys = [key for key, _ in keyed_leaves(template)]
    if len(keys) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(keys)}")
    # dicts keep their insertion order, keyed_leaves walks keys sorted:
    # rebuild by path, not by position
    return _rebuild(template, "", dict(zip(keys, leaves)))


def _rebuild(node, prefix, by_key):
    if isinstance(node, dict):
        return {k: _rebuild(v, prefix + f"[{k!r}]", by_key)
                for k, v in node.items()}
    if _is_namedtuple(node):
        return type(node)(*(_rebuild(getattr(node, f), prefix + f".{f}",
                                     by_key) for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(c, prefix + f"[{i}]", by_key)
                          for i, c in enumerate(node))
    return by_key[prefix]
