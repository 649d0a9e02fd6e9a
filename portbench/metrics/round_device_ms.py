"""Device time of a round: the kernels that the round's graph launch
ran in the traced stretch, summed, per round. Read for
`round_device_ms.<mix>` too."""


def read(ctx):
    return ctx.stretch.round_device_ms() if ctx.stretch else None
