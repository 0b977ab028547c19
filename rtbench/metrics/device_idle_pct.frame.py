"""device_idle_pct.frame: the share of the profiled frames' wall span in which
no device operation ran (100 x (1 - union of device intervals / span))."""

from rtbench.metrics._layers import idle_pct


def read(tr, ctx):
    return idle_pct(tr, ctx, "frames")
