"""Trees of tensors in JAX's leaf order (no counterpart in ``repro``).

The reference numbers a tree's leaves by ``jax.tree_util.tree_flatten``: a
dict's children in sorted key order, a ``NamedTuple``'s fields and a tuple's
or list's items in order, ``None`` an empty subtree, anything else one leaf.
The checkpoint's ``arrays.npz`` names leaves ``"0" .. "n-1"`` in that order
and gradient compression draws per leaf in it, so the port flattens the same
way: then a checkpoint written by either package restores in the other with
every leaf in its place.  :func:`unflatten` rebuilds each dict with its keys
in the order the flattened tree had them, so a restored parameter dict
iterates as the one it was restored into (a float sum over its leaves, such
as the gradients' global norm, then adds in the same order).
"""
from __future__ import annotations

from typing import Any, NamedTuple

__all__ = ["TreeDef", "flatten", "map_leaves", "unflatten"]

_END = object()


class TreeDef(NamedTuple):
    kind: str            # "dict", "namedtuple", "tuple", "list", "none", "leaf"
    node: Any            # dict: its keys in their own order; namedtuple: type
    children: tuple      # child TreeDefs in leaf order (dict: sorted keys)

    def __str__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in zip(
                sorted(self.node), self.children)) + "}"
        inner = ", ".join(str(c) for c in self.children)
        if self.kind == "namedtuple":
            return f"{self.node.__name__}({inner})"
        return f"[{inner}]" if self.kind == "list" else f"({inner})"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def flatten(tree) -> tuple[list, TreeDef]:
    """The leaves of ``tree`` in JAX's order, and its structure."""
    leaves: list = []

    def walk(node) -> TreeDef:
        if node is None:
            return TreeDef("none", None, ())
        if isinstance(node, dict):
            return TreeDef("dict", tuple(node),
                           tuple(walk(node[k]) for k in sorted(node)))
        if _is_namedtuple(node):
            return TreeDef("namedtuple", type(node),
                           tuple(walk(c) for c in node))
        if isinstance(node, (tuple, list)):
            return TreeDef(type(node).__name__, None,
                           tuple(walk(c) for c in node))
        leaves.append(node)
        return TreeDef("leaf", None, ())

    treedef = walk(tree)
    return leaves, treedef


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` (in JAX's order) at its
    leaves; each dict's keys in their original order."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            leaf = next(it, _END)
            if leaf is _END:
                raise ValueError("fewer leaves than the tree has")
            return leaf
        if td.kind == "none":
            return None
        children = [build(c) for c in td.children]
        if td.kind == "dict":
            by_key = dict(zip(sorted(td.node), children))
            return {k: by_key[k] for k in td.node}
        if td.kind == "namedtuple":
            return td.node(*children)
        return list(children) if td.kind == "list" else tuple(children)

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


def map_leaves(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure."""
    leaves, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
