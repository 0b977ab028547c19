"""idle_in_program_pct.frame: of the device's idle time in the profiled
frames, the share in percent during which the host was inside the program's
own code (a ``c2rt.*`` span) and not blocked in one of its host reads
(``c2rt.sync.*``): idle that the program's host code causes.  The rest is
idle outside the program (the harness's copy of the frame, Python between
items)."""

from rtbench.metrics._spans import idle_in_program_pct, readable


def read(tr, ctx):
    return idle_in_program_pct(tr) if readable(tr, ctx, "frames") else None
