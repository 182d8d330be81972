"""Capture and instantiation of the cell's replay graph, seconds, as the
program times it (`replay._ScanGraph.capture_s`); part of set-up."""


def read(ctx):
    return ctx.capture_s
