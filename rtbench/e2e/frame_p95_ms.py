"""frame_p95_ms: the 95th percentile, over every frame of the window, of the
time from issuing a frame to its image being in host memory."""

import statistics


def read(win):
    lat = win["latencies_s"]
    if win["loop"] != "frames" or len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]
