"""Trees of tensors in JAX's leaf order (no counterpart in ``repro``).

The reference numbers a tree's leaves by ``jax.tree_util.tree_flatten``: a
dict's children in sorted key order, a ``NamedTuple``'s fields, a
dataclass's fields (``jax.tree_util.register_dataclass``) and a tuple's or
list's items in order, ``None`` an empty subtree, anything else one leaf.
The reference keeps a dataclass's static fields (a cache's ``ring`` flag)
out of its leaves; here they are leaves, so a caller that wants JAX's
leaves keeps the tensors.
The checkpoint's ``arrays.npz`` names leaves ``"0" .. "n-1"`` in that order
and gradient compression draws per leaf in it, so the port flattens the same
way: then a checkpoint written by either package restores in the other with
every leaf in its place.  The walks are module functions, not closures:
a recursive closure is a reference cycle, which would keep the leaves it
saw alive until the next garbage collection.  :func:`unflatten` rebuilds each dict with its keys
in the order the flattened tree had them, so a restored parameter dict
iterates as the one it was restored into (a float sum over its leaves, such
as the gradients' global norm, then adds in the same order).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

__all__ = ["TreeDef", "flatten", "map_leaves", "unflatten"]

_END = object()


class TreeDef(NamedTuple):
    kind: str            # "dict", "namedtuple", "dataclass", "tuple", "list",
                         # "none", "leaf"
    node: Any            # dict: its keys in their own order; namedtuple: type;
                         # dataclass: (type, field names)
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
        if self.kind == "dataclass":
            return f"{self.node[0].__name__}(" + ", ".join(
                f"{n}={c}" for n, c in zip(self.node[1], self.children)) + ")"
        return f"[{inner}]" if self.kind == "list" else f"({inner})"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _walk(node, leaves: list) -> TreeDef:
    if node is None:
        return TreeDef("none", None, ())
    if isinstance(node, dict):
        return TreeDef("dict", tuple(node),
                       tuple(_walk(node[k], leaves) for k in sorted(node)))
    if _is_namedtuple(node):
        return TreeDef("namedtuple", type(node),
                       tuple(_walk(c, leaves) for c in node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = tuple(f.name for f in dataclasses.fields(node))
        return TreeDef("dataclass", (type(node), names),
                       tuple(_walk(getattr(node, n), leaves) for n in names))
    if isinstance(node, (tuple, list)):
        return TreeDef(type(node).__name__, None,
                       tuple(_walk(c, leaves) for c in node))
    leaves.append(node)
    return TreeDef("leaf", None, ())


def flatten(tree) -> tuple[list, TreeDef]:
    """The leaves of ``tree`` in JAX's order, and its structure."""
    leaves: list = []
    treedef = _walk(tree, leaves)
    return leaves, treedef


def _build(td: TreeDef, it) -> Any:
    if td.kind == "leaf":
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the tree has")
        return leaf
    if td.kind == "none":
        return None
    children = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        by_key = dict(zip(sorted(td.node), children))
        return {k: by_key[k] for k in td.node}
    if td.kind == "namedtuple":
        return td.node(*children)
    if td.kind == "dataclass":
        return td.node[0](**dict(zip(td.node[1], children)))
    return list(children) if td.kind == "list" else tuple(children)


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` (in JAX's order) at its
    leaves; each dict's keys in their original order."""
    it = iter(leaves)
    out = _build(treedef, it)
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
