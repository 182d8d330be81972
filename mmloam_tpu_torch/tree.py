"""Minimal tree utilities over the port's containers.

The reference leans on JAX pytrees; here the containers are NamedTuples
(possibly nested, with None fields), dicts and tuples of tensors.  None
leaves stay None, mirroring JAX's treatment of None as an empty subtree.
"""

from __future__ import annotations


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """Apply `fn` leaf-wise over `tree` and structurally identical `rest`."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, a, *(r[i] for r in rest))
                            for i, a in enumerate(tree)))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, a, *(r[i] for r in rest))
                          for i, a in enumerate(tree))
    return fn(tree, *rest)

