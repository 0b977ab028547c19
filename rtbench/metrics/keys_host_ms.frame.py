"""keys_host_ms.frame: ms per profiled frame that the host spent deriving
threefry keys (the union of the ``c2rt.keys`` spans: every ``prng.split``
and ``prng.fold_in`` of the program; a GI frame's per-path and per-round
splits, a Monte-Carlo frame's per-pass and per-tap ones).  None where the
trace holds no such span."""

from rtbench.metrics._spans import ms_per_item, readable, spans, union

KEYS = "c2rt.keys"


def read(tr, ctx):
    return ms_per_item(tr, union(tr, KEYS)) if readable(tr, ctx, "frames") and spans(tr, KEYS) else None
