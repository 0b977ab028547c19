"""syncs_per_frame: host-blocking CUDA runtime calls (stream, device or event
synchronise, synchronous copies) per profiled frame, less the harness's own
copy of the frame to the host."""

from rtbench.metrics._layers import syncs_per_item


def read(tr, ctx):
    return syncs_per_item(tr, ctx, "frames")
