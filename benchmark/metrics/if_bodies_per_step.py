"""IF-node bodies the one-sequence graph runs a scan, from the predicates
of the window's last job (`replay._ScanGraph.flag_history`); nothing for
a graph without IF nodes."""


def read(ctx):
    return ctx.if_bodies
