"""Helpers over parameter trees: a tensor, or a (named) tuple or list of
trees. Port of the parts of ``repro/common/treeutil.py`` the trainer uses."""

from __future__ import annotations

from typing import Callable

import torch


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``; keeps named tuples' types."""
    if isinstance(tree, (tuple, list)):
        parts = [tree_map(fn, *subs) for subs in zip(tree, *rest)]
        if _is_namedtuple(tree):
            return type(tree)(*parts)
        return type(tree)(parts)
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over all leaves, in f32: ``sqrt(sum_leaf sum(x²))``, the
    reference's order (one sum per leaf, then their sum)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))
