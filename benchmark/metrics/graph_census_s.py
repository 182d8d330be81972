"""The node census of the cell's replay graph and its check against the
launches the wrappers noted, seconds, as the program times it
(`replay._ScanGraph.census_s`, from `spans.last_setup()`); part of
set-up.  Nothing where the program keeps no set-up parts."""

from harness import layers


def read(ctx):
    return layers.setup_part(ctx, "census_s")
