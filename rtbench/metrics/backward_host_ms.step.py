"""backward_host_ms.step: ms per profiled step that the host spent in the
program's backward (the union of the ``c2rt.bwd.*`` spans: K1's re-shade
VJP with its leaf pins, re-shade and inner ``autograd.grad``, and the
texel VJP)."""

from rtbench.metrics._spans import BWD, ms_per_item, readable, union


def read(tr, ctx):
    return ms_per_item(tr, union(tr, BWD)) if readable(tr, ctx, "steps") else None
