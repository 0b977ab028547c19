"""passes_per_frame: the Monte-Carlo passes per profiled frame (the count of
``c2rt.mc_pass`` spans: a DoF sample, or a tap of a frame without DoF; both
eyes of a stereo pair are one).  None where the trace holds no such span (a
frame without DoF or stereo, a program without the span)."""

from rtbench.metrics._spans import readable, spans

PASS = "c2rt.mc_pass"


def read(tr, ctx):
    n = len(spans(tr, PASS)) if readable(tr, ctx, "frames") else 0
    return n / tr.n_items if n else None
