"""frame_ms: the measured window's wall time over the frames completed in it
(one client, closed loop; a frame ends when its image is in host memory)."""


def read(win):
    if win["loop"] != "frames" or not win["n"]:
        return None
    return 1e3 * win["window_s"] / win["n"]
