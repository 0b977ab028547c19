"""idle_in_program_pct.step: of the device's idle time in the profiled steps,
the share in percent during which the host was inside the program's own code
(a ``c2rt.*`` span, the backward's included) and not blocked in one of its
host reads (``c2rt.sync.*``)."""

from rtbench.metrics._spans import idle_in_program_pct, readable


def read(tr, ctx):
    return idle_in_program_pct(tr) if readable(tr, ctx, "steps") else None
