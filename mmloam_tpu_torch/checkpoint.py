"""Checkpoint / resume for the LIO state (port of mmloam_tpu/checkpoint.py).

    checkpoint.save(path, state)
    state = checkpoint.restore(path, template_state)

A checkpoint is a plain `.npz` with one array per leaf, keyed as the
reference keys it: the `jax.tree_util` key path of the leaf joined by "/"
(".x" for a field, ".stacks/.corner" for a nested field, ".preint/['dq']"
for a dict entry; None leaves are absent).  So a checkpoint either package
wrote resumes in the other.  `restore` validates each leaf's shape against
a template built from the same config (`pipeline.init_state(cfg)`) and
puts the leaves on the template's device with its dtypes.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves_with_keys(tree, prefix=()):
    """(key, leaf) pairs in the reference's key format."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves_with_keys(getattr(tree, name),
                                         prefix + (f".{name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], prefix + (f"[{k!r}]",))
    elif isinstance(tree, (tuple, list)):
        for i, a in enumerate(tree):
            yield from _leaves_with_keys(a, prefix + (f"[{i}]",))
    else:
        yield "/".join(prefix), tree


def _rebuild(tree, leaves):
    """`tree` with its leaves replaced, in `_leaves_with_keys` order, by
    the next items of the iterator `leaves`."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), leaves)
                            for n in tree._fields))
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(a, leaves) for a in tree)
    return next(leaves)


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path, state):
    """Write a state (NamedTuples, dicts and tensors) to `path` (.npz)."""
    np.savez_compressed(path, **{k: _host(v)
                                 for k, v in _leaves_with_keys(state)})


def restore(path, template):
    """Load a state saved by `save` (by either package), validated against
    `template`'s structure and shapes, onto the template's devices."""
    leaves = []
    with np.load(path) as data:
        for key, tmpl in _leaves_with_keys(template):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(
                    f"checkpoint leaf {key} shape {arr.shape} != "
                    f"{tuple(tmpl.shape)} (config mismatch?)")
            leaves.append(torch.as_tensor(np.array(arr)).to(
                device=tmpl.device, dtype=tmpl.dtype))
    return _rebuild(template, iter(leaves))
