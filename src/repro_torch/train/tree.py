"""Nested containers of tensors: the port's stand-in for JAX's pytrees.

A tree is a ``NamedTuple``, a ``dict``, a ``list`` or a ``tuple`` of trees,
or a leaf (a tensor, a spec, a number).  Leaves are visited in the order
JAX flattens the same tree: ``NamedTuple`` fields in order, ``dict`` keys
sorted, sequences by index.  A leaf's path names it as the reference's
checkpoints do: the field, key or index of each level joined by ``/``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_named(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any):
    """``[(name, child)]`` of an inner node, or None for a leaf."""
    if _is_named(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in flattening order."""
    out: List[Tuple[str, Any]] = []

    def walk(node: Any, prefix: str) -> None:
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for name, child in kids:
            walk(child, f"{prefix}/{name}" if prefix else str(name))

    walk(tree, "")
    return out


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in flattening order."""
    return [leaf for _path, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *others)`` at every leaf of ``tree``, where ``others`` are
    the nodes of ``rest`` at the same path (a node of ``rest`` may be a
    subtree where ``tree`` has a leaf: int8 moments are ``{"q", "scale"}``
    dicts at a parameter's place)."""
    if _is_named(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: Any, values: List[Any]) -> Any:
    """A tree shaped like ``like`` whose leaves, in flattening order, are
    ``values``."""
    return _rebuild(like, iter(values))


def _rebuild(node: Any, it) -> Any:
    kids = _children(node)
    if kids is None:
        return next(it)
    if _is_named(node):
        return type(node)(*(_rebuild(c, it) for _n, c in kids))
    if isinstance(node, dict):
        built = {k: _rebuild(c, it) for k, c in kids}
        return {k: built[k] for k in node}
    return type(node)(_rebuild(c, it) for _n, c in kids)
