"""env_host_ms.frame: ms per profiled frame that the host spent in the parts
of ``combine_outputs`` that read the environment cubemap (the union of the
``c2rt.env`` spans: both plans, the merged bitmap+cubemap gather with its
nested ``c2rt.gather``, the bilerp and the blend; or the cubemap sample
alone) less the time it sat blocked in the program's own host reads (the
union of ``c2rt.sync.*``).  None where the trace holds no such span."""

from rtbench.metrics._spans import host_issue_ms, readable, spans

ENV = "c2rt.env"


def read(tr, ctx):
    return host_issue_ms(tr, ENV) if readable(tr, ctx, "frames") and spans(tr, ENV) else None
