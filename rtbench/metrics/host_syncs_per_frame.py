"""host_syncs_per_frame: the program's own host reads of device data per
profiled frame, counted from inside (the ``c2rt.sync.*`` spans), beside
``syncs_per_frame``, the CUDA runtime's blocking calls counted from outside."""

from rtbench.metrics._spans import SYNC, readable, spans


def read(tr, ctx):
    return len(spans(tr, SYNC)) / tr.n_items if readable(tr, ctx, "frames") else None
