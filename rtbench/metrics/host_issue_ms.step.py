"""host_issue_ms.step: ms per profiled step that the host spent inside the
forward (``c2rt.frame``) or the program's backward (``c2rt.bwd.*``, on
autograd's thread), the union of both, less the time it sat blocked in the
program's own host reads (``c2rt.sync.*``)."""

from rtbench.metrics._spans import BWD, FRAME, host_issue_ms, readable


def read(tr, ctx):
    return host_issue_ms(tr, FRAME, BWD) if readable(tr, ctx, "steps") else None
