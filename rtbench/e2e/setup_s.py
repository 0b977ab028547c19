"""setup_s: seconds from the process's start (before ``import torch``) to the
first measured item: CUDA's start, loading (or, on a checkout's first run,
building) the kernels, making and packing the scene, and the warm-up items."""


def read(win):
    return win["setup_s"]
