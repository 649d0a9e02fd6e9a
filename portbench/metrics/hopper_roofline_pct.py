"""Share of their roofline that the Hopper kernels (quorum_commit_vote,
term_at_batch) reach in the traced stretch: the summed bound of every
launch (roofline.py, from a spy on one eager round of the live state)
over their summed device time."""


def read(ctx):
    s, bound = ctx.stretch, ctx.hopper_bound_ms_per_round
    if s is None or not bound or s.hopper_us() <= 0:
        return None
    return 100.0 * bound * s.rounds / (s.hopper_us() / 1e3)
