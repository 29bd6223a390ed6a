"""Trees of tensors: nested dicts whose leaves are tensors (or, for
checkpoints, numpy arrays), walked in sorted key order as ``jax.tree_util``
flattens a dict, so that sums over leaves and checkpoint keys follow the
reference's order."""

from __future__ import annotations


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(path, leaf)`` pairs in sorted key order; a path is the ``/``-joined
    keys from the root (the reference's checkpoint keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def leaves(tree) -> list:
    """The leaves in sorted key order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(template, values: list):
    """A tree shaped as ``template`` whose leaves are ``values``, taken in
    the sorted key order of :func:`leaves`."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
