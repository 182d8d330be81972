"""The share of the lockstep graph's replays that ran the init solve, %:
100 x the replays whose "init_solve" IF body ran over every replay of
the lockstep graph since the process started (`spans.gate_counts()`).
Nothing where the program keeps no gate counts, or before a lockstep
graph has replayed."""

from harness import layers


def read(ctx):
    counts = getattr(layers.spans_module(), "gate_counts", None)
    gates = None if counts is None else counts()
    if not gates or not gates.get("scans") or "init_solve" not in gates:
        return None
    return 100.0 * gates["init_solve"] / gates["scans"]
