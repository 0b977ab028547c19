"""sync_wait_ms.frame: ms per profiled frame that the host sat blocked in the
program's own host reads of device data (the union of the ``c2rt.sync.*``
spans: a ``.any()`` or a count brought to the host)."""

from rtbench.metrics._spans import SYNC, ms_per_item, readable, union


def read(tr, ctx):
    return ms_per_item(tr, union(tr, SYNC)) if readable(tr, ctx, "frames") else None
