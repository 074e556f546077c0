"""Nested-container helpers of the training path (the part of
``jax.tree_util`` that the optimizer, the checkpoints and the trainer use).

A tree is dicts, lists and tuples (NamedTuples included) of leaves; a
dataclass that names its data fields in ``_tree_fields`` (the optimizer's
``Quantized``) is a node whose other fields are static; ``None`` is an empty
node, as in JAX.  Anything else is a leaf.  Dict keys are visited sorted,
as JAX visits them, so leaf lists line up.  Paths are spelled as
``jax.tree_util.keystr`` spells them: ``['params']['embed']['w']``,
``[0]``, ``.mu``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Tuple


def _children(node) -> List[Tuple[str, Any]]:
    """(path segment, child) of a node, or [] for a leaf or None."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and hasattr(node, "_tree_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._tree_fields]
    return []


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple)) or (
        dataclasses.is_dataclass(x) and hasattr(x, "_tree_fields"))


def leaves_with_paths(tree, prefix: str = "",
                      is_leaf: Optional[Callable] = None) -> Iterator[Tuple[str, Any]]:
    """Every leaf with its path, depth first; ``is_leaf(x)`` True stops the
    descent at ``x``."""
    if not _is_node(tree) or (is_leaf is not None and is_leaf(tree)):
        yield prefix, tree
        return
    for seg, child in _children(tree):
        yield from leaves_with_paths(child, prefix + seg, is_leaf)


def leaves(tree, is_leaf: Optional[Callable] = None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf=is_leaf)]


def _rebuild(node, children: List[Any]):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, (list, tuple)):
        return type(node)(children)
    return dataclasses.replace(node, **dict(zip(node._tree_fields, children)))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure)."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    kids = [c for _, c in _children(tree)]
    others = [[c for _, c in _children(r)] for r in rest]
    return _rebuild(tree, [tree_map(fn, c, *(o[i] for o in others))
                           for i, c in enumerate(kids)])


def unflatten_like(like, values: List[Any]):
    """``like``'s structure with its leaves replaced, in order, by ``values``."""
    it = iter(values)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
