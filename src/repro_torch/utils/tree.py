"""Small tree helpers over nested dicts, lists, tuples and named tuples of
tensors: the counterpart of ``repro/utils/tree.py``.

A tree is walked as ``jax.tree_util`` walks it, so names and order are
``repro``'s: a dict's keys in sorted order (``torch.utils._pytree`` would
keep insertion order), a list's or tuple's items by index, a named
tuple's fields by name (a path part ``.field``, as JAX's ``GetAttrKey``
prints), ``None`` an empty subtree, and anything else a leaf.  A leaf
with a shape and a dtype (a tensor of any dtype, fp8 and bf16 included,
on any device, ``meta`` included; a numpy array) has bytes.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: Tuple[str, ...], out: list) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], path + (str(k),), out)
    elif _is_namedtuple(tree):
        for f in tree._fields:
            _flatten(getattr(tree, f), path + ("." + f,), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, path + (str(i),), out)
    else:
        out.append((path, tree))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def tree_count(tree) -> int:
    """Total number of scalar elements across all leaves (a leaf without a
    shape counts 1)."""
    return int(sum(math.prod(leaf.shape) if hasattr(leaf, "shape") else 1
                   for _, leaf in _leaves(tree)))


def tree_bytes(tree) -> int:
    """Total bytes across the leaves that have a shape and a dtype."""
    return int(sum(math.prod(leaf.shape) * _itemsize(leaf.dtype)
                   for _, leaf in _leaves(tree)
                   if hasattr(leaf, "shape") and hasattr(leaf, "dtype")))


def _leaves(tree) -> List[Tuple[Tuple[str, ...], Any]]:
    out: list = []
    _flatten(tree, (), out)
    return out


def flatten_with_names(tree) -> List[Tuple[str, Any]]:
    """[(path string, leaf), ...] in tree order, parts joined by ``/``."""
    return [("/".join(p), leaf) for p, leaf in _leaves(tree)]


def tree_map_with_path_str(fn: Callable[[str, Any], Any], tree):
    """A tree of the same structure with each leaf replaced by ``fn(path
    string, leaf)`` (dicts keep their keys, named tuples their type)."""
    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(node[k], path + (str(k),)) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(walk(getattr(node, f), path + ("." + f,))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        return fn("/".join(path), node)
    return walk(tree, ())
