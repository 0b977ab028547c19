"""host_issue_ms.frame: ms per profiled frame that the host spent inside
``render_frame`` (the union of the ``c2rt.frame`` spans) less the time it sat
blocked in the program's own host reads (the union of ``c2rt.sync.*``): the
host's time issuing a frame's work."""

from rtbench.metrics._spans import FRAME, host_issue_ms, readable


def read(tr, ctx):
    return host_issue_ms(tr, FRAME) if readable(tr, ctx, "frames") else None
