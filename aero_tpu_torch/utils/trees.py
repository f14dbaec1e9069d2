"""Trees of tensors: dicts, NamedTuples, lists and tuples (the port's
stand-in for ``jax.tree_util`` where a state or an output is walked)."""

from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of the same structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out
