"""Nested dicts / lists of arrays: the shape of every parameter set here."""

from __future__ import annotations


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of nested dicts, lists and tuples (tuples
    come back as lists, as the parameter stacks are lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
