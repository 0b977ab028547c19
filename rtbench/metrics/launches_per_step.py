"""launches_per_step: device kernels per profiled step, forward and backward
(copies and fills not counted)."""

from rtbench.metrics._layers import launches_per_item


def read(tr, ctx):
    return launches_per_item(tr, ctx, "steps")
