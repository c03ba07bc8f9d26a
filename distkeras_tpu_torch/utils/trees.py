"""Parameter-dict arithmetic (port of ``distkeras_tpu/utils/trees.py``).

A "tree" here is a mapping of names to tensors, as
``dict(model.named_parameters())`` or a state dict: the update algebra of
the trainer zoo (deltas, elastic differences, staleness-weighted sums) is
written with these helpers, leaf by leaf, in the order the JAX package
writes it. Every function returns a new dict of new tensors; the inputs
are not modified.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

Tree = Mapping[str, torch.Tensor]


def tree_add(a: Tree, b: Tree) -> dict:
    """a + b, leafwise."""
    return {n: x + b[n] for n, x in a.items()}


def tree_sub(a: Tree, b: Tree) -> dict:
    """a - b, leafwise."""
    return {n: x - b[n] for n, x in a.items()}


def tree_scale(a: Tree, s) -> dict:
    """a * s for a scalar (a Python number or a 0-d tensor), leafwise."""
    return {n: x * s for n, x in a.items()}


def tree_axpy(alpha, x: Tree, y: Tree) -> dict:
    """alpha * x + y, leafwise (BLAS axpy over trees)."""
    return {n: alpha * xi + y[n] for n, xi in x.items()}


def tree_lerp(a: Tree, b: Tree, t) -> dict:
    """a + t * (b - a), leafwise: elastic attraction toward b."""
    return {n: ai + t * (b[n] - ai) for n, ai in a.items()}


def tree_zeros_like(a: Tree) -> dict:
    return {n: torch.zeros_like(x) for n, x in a.items()}


def tree_mean(trees: Sequence[Tree]) -> dict:
    """Arithmetic mean of a list of trees (AveragingTrainer parity):
    summed left to right, then scaled by ``1 / len(trees)``."""
    acc = dict(trees[0])
    for t in trees[1:]:
        acc = tree_add(acc, t)
    return tree_scale(acc, 1.0 / len(trees))


def tree_weighted_sum(trees: Sequence[Tree], weights) -> dict:
    """sum_i weights[i] * trees[i] over a list of trees."""
    acc = tree_scale(trees[0], weights[0])
    for t, w in zip(trees[1:], weights[1:]):
        acc = tree_add(acc, tree_scale(t, w))
    return acc


def global_norm(tree: Tree) -> torch.Tensor:
    """L2 norm over all leaves, each squared and summed in float32
    (the grad-norm metric). A 0-d float32 tensor on the leaves' device."""
    total = sum(torch.sum(torch.square(x.float())) for x in tree.values())
    return torch.sqrt(total)


def tree_size(tree: Tree) -> int:
    """Total number of scalar parameters."""
    return sum(int(x.numel()) for x in tree.values())


def tree_bytes(tree: Tree) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree.values())


def tree_cast(tree: Tree, dtype: torch.dtype) -> dict:
    """Cast floating leaves to ``dtype``; integer leaves stay as they are."""
    return {n: x.to(dtype) if x.is_floating_point() else x
            for n, x in tree.items()}


# -- nested trees: the JAX package's pytree order ---------------------------
# The wire and the parameter-server fleet move whole trees: nested
# mappings (flax params, state dicts), lists (one shard's leaves) and
# tuples. These flatten in the order ``jax.tree`` flattens them (mapping
# keys sorted at every level, sequences in order), so both packages put
# the same leaf in the same wire slot.

def tree_flatten(tree) -> tuple:
    """``(leaves, treedef)``: the leaves in jax's order and the structure
    :func:`tree_unflatten` rebuilds from it. Mappings, lists and tuples
    are nodes; everything else is a leaf."""
    leaves: list = []

    def walk(node):
        if isinstance(node, Mapping):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node), None, tuple(walk(x) for x in node))
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return next(it)
        kind, keys, children = node
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, children)}
        return kind(build(c) for c in children)

    out = build(treedef)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which must share its structure), structure kept."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t) for t in rest]
    for other_leaves, other_def in others:
        if other_def != treedef:
            raise ValueError("tree structures differ")
    return tree_unflatten(treedef, [
        fn(x, *(o[0][i] for o in others)) for i, x in enumerate(leaves)])
