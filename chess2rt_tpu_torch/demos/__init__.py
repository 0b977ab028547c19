"""Torch twins of the JAX package's showcase demos (demos/*.py at the
repository root), run as ``python -m chess2rt_tpu_torch.demos.<name>``:

    inverse_render     material colors and a sphere's position, alternating
    texture_recovery   the bitmap atlas from flat gray (K2 in the backward)
    bump_inverse       the bump strength and an albedo, bump hybrid's fast forward
    gi_inverse         a wall albedo and the light power through the path tracer
    pod_scaling        rays/s of the sharded frame and step at 1, 2, 4, ... devices
    zaphod_skybox      the DoF + cubemap sky frame (BASELINE config #4), fused or --xla

Each keeps its JAX demo's flags, perturbations, fit schedule, printed lines,
recovery gates (zaphod_skybox: its sky assertion) and exit code, runs on
the card (``--device cpu`` replaces the JAX demos' ``--cpu``; without a card
and without it, it raises), and renders the in-code scenes of ``scenes.py``
that stand in for the scene files the JAX demos read.  ``run(argv)``
returns the demo's numbers as a dict; ``main(argv)`` is its exit code.
"""
