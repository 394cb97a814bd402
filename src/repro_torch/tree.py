"""Parameter trees in the reference's leaf order.

A tree is nested dicts, lists and tuples (NamedTuples included, such as
``optim.adamw.OptState``) of leaves; None is an empty subtree. ``flatten``
visits leaves as ``jax.tree_util.tree_flatten`` does: dicts by sorted key,
sequences in order, depth first. The checkpoint format stores leaves in
this order, and the optimizer sums the global norm in it.
"""
from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten(tree: Tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flatten(v)]
    return [] if tree is None else [tree]


def unflatten(template: Tree, leaves: List[Any]) -> Tree:
    """``template``'s structure rebuilt from leaves in ``flatten`` order
    (a NamedTuple is rebuilt from its fields, ``type(t)(*children)``)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf over trees of one structure."""
    cols = [flatten(t) for t in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(flatten(tree), *cols)])
