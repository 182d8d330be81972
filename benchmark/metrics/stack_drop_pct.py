"""The share of the last replay call's downsampled corner and surf points
that the stack caps (`max_corner`, `max_surf`) dropped, %: 100 x the
dropped over the kept and dropped of `spans.fusion_counts()` (the traced
stretch's last call).  Nothing where the program keeps no fusion counts,
or before a call that downsampled a point."""

from harness import layers


def read(ctx):
    counts = getattr(layers.spans_module(), "fusion_counts", None)
    got = None if counts is None else counts()
    if not got:
        return None
    dropped = got["corner_dropped"] + got["surf_dropped"]
    total = got["corner_kept"] + got["surf_kept"] + dropped
    return 100.0 * dropped / total if total else None
