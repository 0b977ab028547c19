"""The system's entry points, the twin of the JAX package's __graft_entry__.py.

* ``entry(device=None)`` — a single-device forward step on the flagship
  model: the flagship stand-in (``scenes.flagship_standin``: CSG, bitmap
  textures, Phong, transforms, the mirror sphere; lecture5.sdl is not in
  the repository) at 160x120 with 5-tap AA through ``render_frame`` (K1).
* ``dryrun_multichip(n_devices, device=None)`` — the whole distributed
  training path over an n-entry mesh (parallel/mp_dryrun.py).

Both run on the current CUDA device unless ``device`` names another, and
raise without a card.
"""

from __future__ import annotations

from .models import types as TT
from .models.packed import pack_scene
from .ops import prng
from .parallel.mp_dryrun import dryrun_multichip
from .render.pipeline import render_frame
from .scenes import flagship_standin

__all__ = ["dryrun_multichip", "entry"]


def entry(device=None):
    """Returns (fn, example_args): ``fn(packed, key)`` renders the flagship
    stand-in at 160x120 with the 5-sample AA pipeline, ``example_args`` are
    its packed scene on ``device`` and ``PRNGKey(0)``."""
    packed, static = pack_scene(flagship_standin(TT, 160, 120), device=device)

    def fn(packed, key):
        return render_frame(packed, static, key)

    return fn, (packed, prng.PRNGKey(0))
