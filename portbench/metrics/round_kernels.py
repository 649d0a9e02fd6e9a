"""Kernels launched per round by the round's graph and its proposal
copy, in the traced stretch."""


def read(ctx):
    return ctx.stretch.kernels_per_round() if ctx.stretch else None
