"""Pytrees of the port: nested dicts, lists and tuples with leaves.

The flattening order is the JAX package's (``jax.tree_util``): a dict's
children in sorted key order, a list's or tuple's (a named tuple's too) in
position order, ``None`` an empty subtree. So a parameter tree or a
checkpoint flattens to the same leaf sequence in both packages, and a
path string (``keystr``) ends the same way: ``['key']`` for a dict entry,
``[i]`` for a list or tuple position, ``.name`` for a named tuple's field.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

IsLeaf = Optional[Callable[[Any], bool]]

_LEAF = "*"


class TreeDef:
    """The structure of a pytree: what :func:`tree_unflatten` rebuilds.
    ``str`` reads as ``jax.tree_util``'s for dicts, lists, tuples and
    ``None``."""

    __slots__ = ("kind", "meta", "children")

    def __init__(self, kind: str, meta: Any = None,
                 children: Tuple["TreeDef", ...] = ()):
        self.kind, self.meta, self.children = kind, meta, children

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.meta == other.meta
                and self.children == other.children)

    def _body(self) -> str:
        if self.kind == "leaf":
            return _LEAF
        if self.kind == "none":
            return "None"
        parts = [c._body() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {p}" for k, p in
                                   zip(self.meta, parts)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(parts) + "]"
        if self.kind == "tuple":
            return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") \
                + ")"
        return f"{self.meta.__name__}(" + ", ".join(parts) + ")"

    def __str__(self) -> str:
        return f"PyTreeDef({self._body()})"

    __repr__ = __str__


def _structure(x: Any, is_leaf: IsLeaf, path: tuple, out: list) -> TreeDef:
    if is_leaf is not None and is_leaf(x):
        out.append((path, x))
        return TreeDef("leaf")
    if x is None:
        return TreeDef("none")
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return TreeDef("dict", keys, tuple(
            _structure(x[k], is_leaf, path + (f"[{k!r}]",), out)
            for k in keys))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return TreeDef("namedtuple", type(x), tuple(
            _structure(v, is_leaf, path + (f".{n}",), out)
            for n, v in zip(x._fields, x)))
    if isinstance(x, (list, tuple)):
        return TreeDef("list" if isinstance(x, list) else "tuple", None,
                       tuple(_structure(v, is_leaf, path + (f"[{i}]",), out)
                             for i, v in enumerate(x)))
    out.append((path, x))
    return TreeDef("leaf")


def tree_flatten_with_path(tree: Any, is_leaf: IsLeaf = None
                           ) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``([(keystr, leaf), ...], treedef)`` in the JAX package's order."""
    out: list = []
    treedef = _structure(tree, is_leaf, (), out)
    return [("".join(p), leaf) for p, leaf in out], treedef


def tree_flatten(tree: Any, is_leaf: IsLeaf = None
                 ) -> Tuple[List[Any], TreeDef]:
    with_path, treedef = tree_flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in with_path], treedef


def tree_leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    return tree_flatten(tree, is_leaf)[0]


def tree_unflatten(treedef: TreeDef, leaves: Sequence[Any]) -> Any:
    it = iter(leaves)

    def build(d: TreeDef):
        if d.kind == "leaf":
            return next(it)
        if d.kind == "none":
            return None
        kids = [build(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.meta, kids))
        if d.kind == "list":
            return kids
        if d.kind == "tuple":
            return tuple(kids)
        return d.meta(*kids)

    tree = build(treedef)
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"{rest} leaves left over for {treedef}")
    return tree


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: IsLeaf = None
             ) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which must share its structure)."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r, is_leaf)
        if r_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} vs {r_def}")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
