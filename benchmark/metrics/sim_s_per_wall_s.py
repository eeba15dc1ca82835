"""sim_s_per_wall_s: the simulated seconds all the window's chunks
advanced over the window's wall seconds (host clock; each chunk ends with
its readings on the host)."""


def read(ctx):
    if ctx.unit != "sim-seconds" or ctx.calls == 0:
        return None
    return ctx.work / ctx.wall_s
