"""plant_steps_per_s (and ``plant_steps_per_s.<cells>``): every
plant-step the window's calls completed over the window's wall seconds
(host clock, ending after the device is done)."""


def read(ctx):
    if ctx.unit != "plant-steps" or ctx.calls == 0:
        return None
    return ctx.work / ctx.wall_s
