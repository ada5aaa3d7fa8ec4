"""Trees of tensors: the dicts and lists the port keeps params, optimizer
state and checkpoints in, walked in the reference's pytree order (dict
keys sorted, list items in order) and named by its key paths."""

from __future__ import annotations


def tree_map(fn, *trees):
    """`fn` over the leaves of trees of one layout; dicts and lists are
    nodes, anything else (a tensor, a QuantizedTensor) a leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees))
                for i in range(len(first))]
    return fn(*trees)


def flatten_with_path(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(key path, leaf) in the reference's flatten order; a path is what
    `jax.tree_util.keystr` writes for it: `['opt']['mu']['stack']` for dict
    keys, `[0]` for a list index."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_unflatten(like, leaves):
    """A tree of `like`'s layout holding `leaves` in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out
