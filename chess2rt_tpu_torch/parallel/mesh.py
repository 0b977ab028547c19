"""Distribution: the frame rendered as contiguous pixel slices, one per
mesh entry, in one process.

Counterpart of the single-process part of chess2rt_tpu/parallel/mesh.py
(its fused branch).  The reference's only parallelism is a thread pool over
image buckets (renderer.d:133-136); here:

* a mesh is a 1-D tuple of ``torch.device``s, one entry per shard.  The same
  device may appear more than once: that is how one card renders lane bases
  above 0, and what the JAX package's virtual host devices are in its tests;
* the flat pixel grid is padded to ``n_pad = n + (-n) % (n_shards * 128)``
  and cut into ``n_shards`` slices of ``C = n_pad // n_shards`` lanes; the
  scene is replicated (``packed.to(device)``);
* shard ``i`` renders pixels [i * C, (i + 1) * C) on its device through
  ``ops/flagship.build_rows_renderer`` (K1's lin-input form, ray-gen in the
  kernel from the lane base), so no pixel coordinates ship at all.  The
  forward needs no exchange between shards; slices are gathered on the first
  device.  Adaptive AA detects on the gathered whole base frame, since the
  detect reads neighbours across slices;
* the gradient step sums the shards' losses and parameter gradients on the
  first device, where the JAX package has ``psum``.

The shards of one process run one after the other from the host's point of
view (each slice's host decisions synchronise its device).  Scenes and
dtypes the JAX package sends to its XLA per-shard sampler (MC modes, GI,
float64, geometry the round-0 kernel does not cover) raise
NotImplementedError naming their ROADMAP item; on one device
``render_frame`` renders float64 and uncovered scenes through the eager
Whitted twin.  ``make_mesh_2d``, several processes and
``torch.distributed`` are ROADMAP.md queue 1 item 11.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..models.packed import ScenePacked, SceneStatic, from_leaves, leaves
from ..ops.flagship import build_rows_renderer
from ..ops.round0 import BOUNCE_BLOCK, round0, supports

Mesh = Tuple[torch.device, ...]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh: one ``torch.device`` per shard, by default every visible
    CUDA device once.  Without a card and without ``devices`` it raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh: no CUDA device; pass devices=("cpu", ...) to shard on the CPU')
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return mesh


def _frame_from_samples(flat, static: SceneStatic):
    n = static.width * static.height
    return flat[:n].reshape(static.height, static.width, 3)


def _mask_from_base(base_flat, static: SceneStatic):
    """Padded flat needs-AA mask from the padded flat base pass (adaptive
    AA): the detect runs on the whole [H, W, 3] frame."""
    from ..render.pipeline import aa_detect

    n = static.width * static.height
    pad = base_flat.shape[0] - n
    mask = aa_detect(base_flat[:n].reshape(static.height, static.width, 3)).reshape(-1)
    return torch.cat([mask, torch.zeros(pad, dtype=torch.bool, device=mask.device)])


def _fused_shard_setup(static: SceneStatic, mesh: Mesh, trace=round0):
    """(rows, C, n_pad) for this mesh: ``rows`` renders one contiguous
    C-lane pixel slice (``build_rows_renderer``); the frame pads to ``n_pad
    = n_shards * C`` with C a multiple of 128, so block-granular bounce
    compaction stays live per shard.  Raises NotImplementedError for what
    the JAX package renders through its XLA per-shard sampler."""
    if static.gi_enabled:
        raise NotImplementedError(
            "sharded GI frames (the JAX package's per-shard XLA sampler, a fold_in of the key per shard) are "
            "not ported yet (ROADMAP.md queue 1 item 11)"
        )
    if static.dof or static.stereo:
        raise NotImplementedError(
            "sharded DoF and stereo frames (the JAX package's per-shard sampler, a fold_in of the key per "
            "shard) are not ported yet (ROADMAP.md queue 1 item 11)"
        )
    if not supports(static):
        raise NotImplementedError(
            "sharding a scene the round-0 kernel does not cover (the JAX package's per-shard XLA "
            "sampler) is not ported yet (ROADMAP.md queue 1 item 11)"
        )
    n_shards = len(mesh)
    n = static.width * static.height
    n_pad = n + (-n) % (n_shards * BOUNCE_BLOCK)
    C = n_pad // n_shards
    return build_rows_renderer(static, static.width, static.height, C, trace=trace), C, n_pad


def _check_dtype(packed: ScenePacked):
    if packed.dtype != torch.float32:
        raise NotImplementedError(
            "sharded float64 frames (the JAX package's per-shard XLA sampler) are not ported yet "
            "(ROADMAP.md queue 1 item 11); render_frame renders float64 frames on one device"
        )


def _replicate(packed: ScenePacked, mesh: Mesh):
    """The scene on every mesh entry's device (one copy per distinct device)."""
    copies = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = packed if packed.device == dev else packed.to(dev)
    return [copies[dev] for dev in mesh]


def make_sharded_render_fn(static: SceneStatic, mesh: Mesh, trace=round0):
    """``fn(packed, key=None) -> [H, W, 3]`` on the mesh's first device, the
    pixels sharded over the mesh (see the module docstring).  ``key`` is
    accepted for the JAX signature and unused: the deterministic Whitted
    path draws no random numbers."""
    rows, C, _ = _fused_shard_setup(static, mesh, trace)
    adaptive = static.aa_enabled and static.aa_adaptive
    first = mesh[0]

    def gather(render):
        return torch.cat([render(i, dev).to(first) for i, dev in enumerate(mesh)])

    def fn(packed: ScenePacked, key=None):
        del key
        _check_dtype(packed)
        scenes = _replicate(packed, mesh)
        if not adaptive:
            flat = gather(lambda i, dev: rows(scenes[i], i * C))
        else:
            base = gather(lambda i, dev: rows.tap(scenes[i], i * C))
            mask = _mask_from_base(base, static)
            flat = gather(lambda i, dev: rows(scenes[i], i * C, mask=mask[i * C:(i + 1) * C].to(dev),
                                              base=base[i * C:(i + 1) * C].to(dev)))
        return _frame_from_samples(flat, static)

    return fn


def render_frame_distributed(packed: ScenePacked, static: SceneStatic, mesh: Optional[Mesh] = None, key=None):
    """One-shot sharded render."""
    mesh = mesh if mesh is not None else make_mesh()
    return make_sharded_render_fn(static, mesh)(packed, key)


def make_sharded_value_and_grad(static: SceneStatic, mesh: Mesh, trace=round0):
    """``fn(packed, target_hw3, key=None) -> (loss, grads)`` for inverse
    rendering: the pixel-sharded forward, one backward per shard, and the
    shards' losses and parameter gradients summed on the mesh's first
    device.  loss = mean squared error against the target frame; ``grads``
    is a ScenePacked of gradients (zeros where a leaf has none).

    Under adaptive AA the mask comes from a separate forward base pass
    without a graph; each shard re-renders its base tap inside the graph,
    so unflagged pixels keep their gradient."""
    rows, C, n_pad = _fused_shard_setup(static, mesh, trace)
    adaptive = static.aa_enabled and static.aa_adaptive
    first = mesh[0]
    n = static.width * static.height

    def fn(packed: ScenePacked, target, key=None):
        del key
        _check_dtype(packed)
        pad = n_pad - n
        tflat = torch.cat([target.reshape(-1, 3).to(first, torch.float32),
                           torch.zeros((pad, 3), dtype=torch.float32, device=first)])
        # the weight zeroes the pad lanes (pixels below the frame), so they
        # do not reach the loss
        weight = torch.cat([torch.ones(n, dtype=torch.float32, device=first),
                            torch.zeros(pad, dtype=torch.float32, device=first)])
        scenes = _replicate(packed, mesh)
        mask = None
        if adaptive:
            with torch.no_grad():
                base = torch.cat([rows.tap(scenes[i], i * C).to(first) for i in range(len(mesh))])
            mask = _mask_from_base(base, static)
        loss = torch.zeros((), dtype=torch.float32, device=first)
        total = [torch.zeros_like(x, device=first) for x in leaves(packed)]
        for i, dev in enumerate(mesh):
            sl = slice(i * C, (i + 1) * C)
            xs = [x.detach().requires_grad_(x.is_floating_point()) for x in leaves(scenes[i])]
            img = rows(from_leaves(xs), i * C, mask=mask[sl].to(dev) if adaptive else None)
            shard_loss = ((img - tflat[sl].to(dev)) ** 2 * weight[sl].to(dev)[:, None]).sum() / (n * 3)
            wanted = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(shard_loss, wanted, allow_unused=True))
            for acc, x in zip(total, xs):
                g = next(got) if x.requires_grad else None
                if g is not None:
                    acc += g.to(first)
            loss = loss + shard_loss.detach().to(first)
        return loss, from_leaves(total)

    return fn
