"""Parameter trees: nested dicts (and lists) of leaves, walked in the
reference's leaf order, which is ``jax.tree``'s: dict keys sorted at
every level, list items in order.  Tuples (``ParamSpec``, ``AdamWState``)
are leaves here."""
from __future__ import annotations


def param_leaves(tree, prefix: tuple = ()) -> list:
    """(path, leaf) pairs of a nested dict / list in the reference's leaf
    order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in param_leaves(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree)
                for pl in param_leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_from_leaves(paths_leaves) -> dict:
    """The nested dict of (path, leaf) pairs."""
    out: dict = {}
    for path, leaf in paths_leaves:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (and of trees of the
    same structure in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)
