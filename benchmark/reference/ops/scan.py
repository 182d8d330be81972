"""Parallel prefix scan along axis 0 with the reference's combine tree.

`associative_scan` follows the recursion of `jax.lax.associative_scan`
(pair adjacent elements, scan the pairs, fix up the evens), so a port
function that used it combines its operands in the same tree as the
reference — log-depth on the device, and f32 rounding that follows the
same grouping.
"""

from __future__ import annotations

import torch


def _interleave(a, b):
    """Interleave a (n_a, ...) and b (n_b, ...) along axis 0, a first."""
    n = a.shape[0] + b.shape[0]
    out = torch.empty((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn, elems):
    """Inclusive scan of the tuple of arrays `elems` along axis 0.

    `fn(left, right)` combines two tuples of equally shaped batches.
    """
    elems = tuple(elems)
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[0:1], r], dim=0) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))
