"""Share of the window's time in which the device waited for the host:
from the end of each round to the start of the next, both CUDA events on
the device's clock (loop.Clock), summed over the window's rounds outside
the traced stretch, over the time from the first's end to the last's.
Gaps between kernels inside a round's graph are not in it: under the
profiler the host submits a graph's kernels more slowly than short
rounds run them, so no trace shows them as they are. Read for
`device_idle_pct.<mix>` too."""


def read(ctx):
    return ctx.device_wait_pct
