"""step_ms: the measured window's wall time over the gradient steps completed
in it (one client, closed loop; a step ends when its loss and gradient
checksum are read on the host)."""


def read(win):
    if win["loop"] != "steps" or not win["n"]:
        return None
    return 1e3 * win["window_s"] / win["n"]
