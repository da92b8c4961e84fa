"""Walking the port's state trees: nested dicts, lists, tuples, dataclasses
(``AttentionState``, ``LLNState``, ...) and ``nn.Module`` parameters, with
tensors (or ``None``) at the leaves.

The reference gets this from ``jax.tree_util``; the port's trees are the
per-layer cache lists, the train state ``{"params": nn.Module, "opt":
{...}}`` and the pool's snapshot dict.  A leaf's path is the tuple of keys
that reach it (dict keys, list indices, dataclass field names, a module's
dotted parameter names), so the last key names the leaf (``alpha``,
``s``, ``state``) as the reference's key paths do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import torch
from torch import nn


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if isinstance(node, nn.Module):
        return list(node.named_parameters())
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def leaves_with_path(tree, path: tuple = ()) -> Iterator[tuple]:
    """(path, leaf) for every non-None leaf, in walk order."""
    kids = _children(tree)
    if kids is None:
        if tree is not None:
            yield path, tree
        return
    for key, child in kids:
        yield from leaves_with_path(child, path + (key,))


def path_str(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def map_with_path(fn: Callable[[tuple, Any], Any], tree, path: tuple = ()):
    """The tree with every non-None leaf replaced by ``fn(path, leaf)``.
    Dicts, lists, tuples and dataclasses keep their type; an ``nn.Module``
    becomes a dict of its parameter names."""
    kids = _children(tree)
    if kids is None:
        return None if tree is None else fn(path, tree)
    out = {k: map_with_path(fn, c, path + (k,)) for k, c in kids}
    if isinstance(tree, (list, tuple)):
        return type(tree)(out[i] for i in range(len(tree)))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, nn.Module):
        return dataclasses.replace(tree, **out)
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves at the same path of rest)`` over ``tree``."""
    others = [dict(leaves_with_path(t)) for t in rest]
    return map_with_path(lambda p, a: fn(a, *(o[p] for o in others)), tree)


def float_leaf(a) -> bool:
    return torch.is_tensor(a) and a.is_floating_point()
