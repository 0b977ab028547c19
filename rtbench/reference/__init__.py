"""The benchmark's plain reference: a frozen copy of the port's eager twin
(plain PyTorch, no hand-written kernel) and its threefry, which works out
again from the inputs every frame, ray count and gradient that the timed
path produced.  Nothing here imports the program (``chess2rt_tpu_torch``)
or the JAX package."""
