"""The share of the last replay call's lane-scans whose Horizon sweep was
merged into the estimate, %: 100 x `hori_merged` over `lane_scans` of
`spans.fusion_counts()` (the traced stretch's last call).  Nothing where
the program keeps no fusion counts, or before a call."""

from harness import layers


def read(ctx):
    counts = getattr(layers.spans_module(), "fusion_counts", None)
    got = None if counts is None else counts()
    if not got or not got.get("lane_scans"):
        return None
    return 100.0 * got["hori_merged"] / got["lane_scans"]
