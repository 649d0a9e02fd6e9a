"""How late the open loop handed its arrivals over: the host's clock at
the offer of the round that took each arrival, less its due time, 99th
percentile over the window's arrivals."""


def read(ctx):
    return ctx.gen_lag_p99_ms
