"""Host time inside each run_rounds call of the window (the proposal
copy, the graph launch and the engine's Python around them), mean over
the window's rounds outside the traced stretch."""


def read(ctx):
    return sum(ctx.replay_ms) / len(ctx.replay_ms) if ctx.replay_ms else None
