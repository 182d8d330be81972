"""The instantiation of the cell's replay graph, seconds, as the program
times it (`replay._ScanGraph.instantiate_s`, from `spans.last_setup()`;
part of `graph_capture_s`); part of set-up.  Nothing where the program
keeps no set-up parts."""

from harness import layers


def read(ctx):
    return layers.setup_part(ctx, "instantiate_s")
