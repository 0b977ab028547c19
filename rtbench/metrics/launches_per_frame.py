"""launches_per_frame: device kernels per profiled frame (copies and fills
not counted)."""

from rtbench.metrics._layers import launches_per_item


def read(tr, ctx):
    return launches_per_item(tr, ctx, "frames")
