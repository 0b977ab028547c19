"""Frame rendering entry point (renderer.d:254-313).

Counterpart of chess2rt_tpu/render/pipeline.py.  ``render_frame`` takes the
fused path (ops/flagship.py, the round-0 kernel + torch glue) for the
deterministic Whitted modes it covers (un-chunked and ``chunk_pixels``
frames, quirk and adaptive AA); every other mode raises
NotImplementedError naming the ROADMAP item that ports it.  The XLA
wavefront twin (``trace_whitted``) is not ported.
"""

from __future__ import annotations

import torch

from ..models.packed import ScenePacked, SceneStatic

# AA kernel offsets (renderer.d:235-242); sample 0 is the pass-2 sample.
AA_KERNEL = ((0.3, 0.3), (0.6, 0.0), (0.0, 0.6), (0.6, 0.6))


def compact_indices(alive, n: int, cap: int):
    """sel[j] = flat index of the j-th live lane in ascending order; junk
    slots past the live count hold the out-of-range sentinel ``n``."""
    keys = torch.where(alive, torch.arange(n, dtype=torch.int32, device=alive.device), n)
    out = torch.sort(keys).values
    if cap <= n:
        return out[:cap]
    return torch.cat([out, torch.full((cap - n,), n, dtype=torch.int32, device=alive.device)])


def aa_detect(img):
    """The reference's needs-AA detect pass (renderer.d:150-178): a pixel
    is flagged when any member of its clamped 5-point neighbourhood differs
    from the neighbourhood average by too_different's default 0.1 threshold
    (AAThreshold is never forwarded, the renderer.d:172 quirk).  Accumulated
    in f32 like the reference's Color.  [H, W, 3] -> [H, W] bool, detached
    from the graph (the mask is a discrete decision)."""
    from ..utils.color import too_different

    f32 = img.detach().to(torch.float32)
    neighs = [
        f32,
        torch.cat([f32[:, :1], f32[:, :-1]], dim=1),  # x-1 (clamped)
        torch.cat([f32[:, 1:], f32[:, -1:]], dim=1),  # x+1
        torch.cat([f32[:1, :], f32[:-1, :]], dim=0),  # y-1
        torch.cat([f32[1:, :], f32[-1:, :]], dim=0),  # y+1
    ]
    # the JAX package sums from Python's 0: ((((0 + a) + b) + c) + d) + e
    avg = (neighs[0] + neighs[1] + neighs[2] + neighs[3] + neighs[4]) / 5.0
    needs = torch.zeros(img.shape[:2], dtype=torch.bool, device=img.device)
    for nb in neighs:
        needs = needs | too_different(nb, avg)
    return needs


def _unported(static: SceneStatic, dtype):
    """The ROADMAP item a frame needs before it can render here, or None."""
    from ..ops.round0 import supports

    if dtype != torch.float32:
        return "float64 frames (ROADMAP.md queue 1 item 3: the eager Whitted twin)"
    if static.gi_enabled:
        return "GI (ROADMAP.md queue 1 item 8)"
    if static.dof or static.stereo:
        return "DoF and stereo (ROADMAP.md queue 1 item 7)"
    if static.has_bump:
        return "bump maps (ROADMAP.md queue 1 item 9)"
    if static.has_env:
        return "environment cubemaps (ROADMAP.md queue 1 item 10)"
    if static.compensated_raygen:
        return "compensated ray-gen (ROADMAP.md queue 1 item 10)"
    if not supports(static):
        return "this scene (ROADMAP.md queue 1 item 3: the eager Whitted twin)"
    return None


def render_frame(packed: ScenePacked, static: SceneStatic, key=None):
    """Full-frame render -> float [H, W, 3] on the scene's device.

    ``key`` is accepted for the JAX signature and unused: the deterministic
    Whitted AA path draws no random numbers."""
    del key
    W, H = static.width, static.height
    todo = _unported(static, packed.dtype)
    if todo is not None:
        raise NotImplementedError(f"render_frame: {todo} is not ported yet")
    from ..ops.flagship import build_flagship_renderer

    return build_flagship_renderer(static, W, H)(packed)
