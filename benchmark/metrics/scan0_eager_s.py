"""Scan 0's eager step before the capture of the cell's replay graph, seconds,
as the program times it on the host (`replay._ScanGraph.eager_s`, from
`spans.last_setup()`; its device tail lands in the capture's); part of
set-up.  Nothing where the program keeps no set-up parts."""

from harness import layers


def read(ctx):
    return layers.setup_part(ctx, "eager_s")
