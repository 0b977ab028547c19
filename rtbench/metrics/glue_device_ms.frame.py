"""glue_device_ms.frame: device ms per profiled frame of every kernel that is
not one of the hand-written ones named in glue_device_ms.frame.json (K1, K2,
the draws): the torch glue's device time."""

from rtbench.metrics._layers import device_ms_per_item


def read(tr, ctx):
    if ctx["loop"] != "frames" or not tr.kernels:
        return None
    return device_ms_per_item(tr, ctx["data"]["kernels"], inside=False)
