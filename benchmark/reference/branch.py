"""One lane's `lax.cond` and bounded `while_loop`, op by op.

Frozen plain copy of the eager half of the port's `branch` module: each
predicate (a bool tensor of one element) is read on the host, so one
branch runs and the loop stops where its lane is done.  The one-lane
step (`pipeline.step_core_one`) takes these; the lockstep step selects
and never calls them.
"""

from __future__ import annotations


def cond(pred, true_fn, false_fn, operand):
    """`lax.cond(pred, true_fn, false_fn, operand)` at one lane; None for a
    branch is the identity."""
    fn = true_fn if bool(pred) else false_fn
    return operand if fn is None else fn(operand)


def loop(n, live_fn, body_fn, carry):
    """A `while_loop` at one lane bounded by n iterations: for it in
    range(n), while `live_fn(it, carry)` holds, `carry = body_fn(it, live,
    carry)`."""
    for it in range(n):
        live = live_fn(it, carry)
        if not bool(live):
            break
        carry = body_fn(it, live, carry)
    return carry
