"""raygen_host_ms.frame: ms per profiled frame that the host spent in the
Monte-Carlo passes' ray generation (the union of the ``c2rt.raygen`` spans:
the key splits, the jitter and disc draws and ``screen_rays``, everything
before a pass's first K1 call) less the time it sat blocked in the
program's own host reads (the union of ``c2rt.sync.*``).  None where the
trace holds no such span."""

from rtbench.metrics._spans import host_issue_ms, readable, spans

RAYGEN = "c2rt.raygen"


def read(tr, ctx):
    return host_issue_ms(tr, RAYGEN) if readable(tr, ctx, "frames") and spans(tr, RAYGEN) else None
