"""k1_roofline_pct.frame: the least time of the K1 work a frame's rays need
(rtbench/roofline.py, from the configuration's ray counts and the benchmark's
own scene description) over the device time per frame of the kernels named
in k1_roofline_pct.frame.json, in percent.  None without K1 kernels or ray
counts."""

from rtbench import roofline
from rtbench.metrics._layers import device_ms_per_item


def read(tr, ctx):
    rays = ctx["mode"].get("rays")
    if ctx["loop"] != "frames" or not rays:
        return None
    k1_ms = device_ms_per_item(tr, ctx["data"]["kernels"], inside=True)
    if k1_ms <= 0:
        return None
    ops, n_bytes = roofline.k1_work(ctx["ref_static"], ctx["ref_packed"], rays, ctx["mode"]["width"],
                                    ctx["mode"]["height"])
    least_s, _ = roofline.least_seconds(ops, n_bytes)
    return 100.0 * least_s * 1e3 / k1_ms
