"""Nested param trees (dicts, lists, NamedTuples of tensors) walked in the
JAX package's order: a NamedTuple's fields in order, a dict's keys sorted, a
list's items in order; ``None`` holds no leaf. Paths name the steps as
``jax.tree_util`` prints them: ``.field`` for a NamedTuple field, the key
for a dict, the index for a list (a checkpoint's leaf names, e.g.
``.params/embed/table``, are these joined by ``/``)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_paths(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) for every leaf, in the reference's flatten order."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        for name in tree._fields:
            yield from leaves_with_paths(getattr(tree, name), prefix + (f".{name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree: Any, flat: list) -> Any:
    """A tree of ``tree``'s structure whose leaves are ``flat``, taken in the
    flatten order of :func:`leaves_with_paths`."""
    it = iter(flat)

    def build(node):
        if node is None:
            return None
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree)
