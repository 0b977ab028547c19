"""Distribution: the frame rendered as contiguous pixel slices, one per
mesh entry, in one process or across processes.

Counterpart of chess2rt_tpu/parallel/mesh.py.  The reference's only
parallelism is a thread pool over image buckets (renderer.d:133-136); here:

* a mesh is a 1-D tuple of ``torch.device``s, one entry per shard, rendered
  by this process, or a ``GridMesh``: the 2-D (hosts, chips) mesh of
  ``make_mesh_2d``, or a mesh whose entries belong to several processes
  (``make_mesh()`` after ``initialize_distributed``, parallel/
  distributed.py).  The same device may appear more than once: that is how
  one card renders lane bases above 0, and what the JAX package's virtual
  host devices are in its tests.  Shard ``i`` is entry ``i`` in row-major
  order (``h * chips + c`` on the 2-D mesh: the JAX package's
  ``_linear_index``), so a 2-D mesh renders the 1-D mesh's frame over the
  same devices;
* the scene is replicated (``packed.to(device)``), the flat pixel grid is
  cut into ``n_shards`` slices, and shard ``i`` renders its slice on its
  device.  Deterministic float32 frames of the scenes K1 covers go through
  ``ops/flagship.build_rows_renderer`` (K1's lin-input form, ray-gen in the
  kernel from the lane base), the grid padded to ``n_shards * C`` lanes with
  C a multiple of 128 (``_fused_shard_setup``).  Every other frame (DoF,
  stereo, GI, float64, scenes K1 does not cover) goes through the per-shard
  sampler (``_sample_pixels``): ``render_samples`` of the eager twin on the
  shard's pixel coordinates, the grid padded to a multiple of ``n_shards``
  only (padding pixels re-render pixel (0, 0)), the key folded with the
  shard index, and K1 plugged in as the tracer (``_fused_trace_fns``: the
  ray-input form and the bounce finisher for Whitted rays, the fused GI
  tracer for GI paths; float64 rays stay on the twin), as JAX's
  ``trace_fn`` / ``gi_trace_fn`` hooks do.  Because of the per-shard keys
  a sharded Monte-Carlo frame is not the single-device frame: it is the
  JAX package's sharded frame under the same key and shard count;
* slices are gathered on the first entry this process renders; across
  processes, each rank fills its slices of a zero frame and an all-reduce
  sums them, so every rank holds the whole frame.  Adaptive AA detects on
  the gathered whole base frame, since the detect reads neighbours across
  slices;
* the gradient step sums the shards' losses and parameter gradients, per
  host row first, then across rows (the two stages of JAX's ``psum`` on a
  (host, chip) mesh), then across processes by one all-reduce of a flat
  buffer.

The shards of one process run one after the other from the host's point of
view (each slice's host decisions synchronise its device).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.packed import ScenePacked, SceneStatic, from_leaves, leaves
from ..ops import prng
from ..ops.camera import begin_frame
from ..ops.flagship import build_rows_renderer
from ..ops.round0 import BOUNCE_BLOCK, round0, supports, supports_gi
from . import distributed as D

Mesh = Tuple[torch.device, ...]


@dataclass(frozen=True)
class GridMesh:
    """A mesh as a row-major grid of entries: ``shape`` is (n,) or (hosts,
    chips), ``entries`` the flat devices, ``ranks`` the process that renders
    each entry (None: this process renders them all).  ``devices`` nests
    the entries by ``shape``."""

    shape: Tuple[int, ...]
    entries: Tuple[torch.device, ...]
    ranks: Optional[Tuple[int, ...]] = None

    @property
    def devices(self):
        if len(self.shape) == 1:
            return self.entries
        c = self.shape[1]
        return tuple(self.entries[h * c:(h + 1) * c] for h in range(self.shape[0]))


def _visible_cards(who: str):
    if not torch.cuda.is_available():
        raise RuntimeError(f'{who}: no CUDA device; pass devices=("cpu", ...) to shard on the CPU')
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None):
    """A 1-D mesh.  ``devices`` given: one ``torch.device`` per shard, all
    rendered by this process (a tuple).  Without it: every device of every
    process after ``initialize_distributed`` brought up several (a
    ``GridMesh``), else every visible CUDA device once (a tuple); without a
    card it raises."""
    if devices is None:
        spread = D.global_devices()
        if spread is not None:
            return GridMesh((len(spread),), tuple(d for _, d in spread), tuple(r for r, _ in spread))
        devices = _visible_cards("make_mesh")
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return mesh


def make_mesh_2d(devices: Optional[Sequence] = None, hosts: Optional[int] = None) -> GridMesh:
    """The 2-D (hosts, chips) mesh: pixels shard over both axes (shard ``h *
    chips + c``), and the gradient sums over chips within a host, then over
    hosts.  ``devices`` as ``make_mesh``'s.  ``hosts`` defaults to the
    process count when several processes share the mesh and it divides the
    entries, else to the largest power of two whose square does not exceed
    the entry count (the JAX package's split)."""
    if devices is None and D.global_devices() is not None:
        spread = D.global_devices()
        entries, ranks = tuple(d for _, d in spread), tuple(r for r, _ in spread)
    else:
        entries, ranks = tuple(torch.device(d) for d in (devices or _visible_cards("make_mesh_2d"))), None
    n = len(entries)
    if hosts is None:
        hosts = D.process_count() if ranks is not None else 1
        if hosts <= 1 or n % hosts:
            hosts = 1
            while n % (hosts * 2) == 0 and (hosts * 2) ** 2 <= n:
                hosts *= 2
    if not n or n % hosts:
        raise ValueError(f"make_mesh_2d: {n} devices do not split into {hosts} hosts")
    return GridMesh((hosts, n // hosts), entries, ranks)


def _plan(mesh):
    """(entries, ranks or None, rows, owned): the flat entries, their
    processes, the number of host rows, and the shard indices this process
    renders."""
    if isinstance(mesh, GridMesh):
        entries, ranks, shape = mesh.entries, mesh.ranks, mesh.shape
    else:
        entries, ranks, shape = tuple(mesh), None, (len(mesh),)
    me = D.process_index()
    owned = [i for i in range(len(entries)) if ranks is None or ranks[i] == me]
    if not owned:
        raise ValueError(f"mesh: process {me} renders none of the {len(entries)} entries")
    return entries, ranks, (shape[0] if len(shape) == 2 else 1), owned


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


def _pixel_coords(static: SceneStatic, n_shards: int, dtype=np.float64):
    """Flat pixel coordinates padded to a multiple of the shard count:
    (xf, yf, n) as numpy arrays.  Padding pixels re-render pixel (0, 0) and
    are dropped on reshape."""
    W, H = static.width, static.height
    n = W * H
    pad = (-n) % n_shards
    ys, xs = np.mgrid[0:H, 0:W]
    xf = np.concatenate([xs.reshape(-1), np.zeros(pad, dtype=np.int64)])
    yf = np.concatenate([ys.reshape(-1), np.zeros(pad, dtype=np.int64)])
    return xf.astype(dtype), yf.astype(dtype), n


def _sample_pixels(packed: ScenePacked, static: SceneStatic, xf, yf, key, mask=None, base=None,
                   trace_fn=None, gi_trace_fn=None):
    """One shard's pixels, the AA taps included: the base sample from
    ``key`` itself, AA tap i (1..4) from ``fold_in(key, i)`` (the single
    device's ``_render_pixels`` splits instead), each pass in
    ``chunk_pixels`` slabs with a key per slab (``_flat_pass``).

    ``mask``: this shard's slice of the whole frame's needs-AA mask
    (adaptive AA; the detect reads neighbours across shards, so the caller
    computes it on the gathered base frame).  ``base``: the shard's base
    sample already rendered (the forward adaptive path); gradient callers
    leave it None so unflagged pixels keep their gradient."""
    from ..render.pipeline import _flat_pass, _offsets, render_samples

    frame = begin_frame(packed.camera, static.width / static.height)
    fn = functools.partial(render_samples, trace_fn=trace_fn, gi_trace_fn=gi_trace_fn)
    img = base if base is not None else _flat_pass(packed, static, frame, xf, yf, key, fn)
    if static.aa_enabled:
        acc = img
        for i, off in enumerate(_offsets(xf), start=1):
            acc = acc + _flat_pass(packed, static, frame, xf + off[0], yf + off[1], prng.fold_in(key, i), fn)
        img = torch.where(mask[:, None], acc / 5.0, img) if mask is not None else acc / 5.0
    return img


def _fused_shard_setup(static: SceneStatic, mesh, trace=round0):
    """(rows, C, n_pad) of the deterministic fused path for this mesh, or
    None when the scene goes through the per-shard sampler (DoF, stereo,
    GI, geometry K1 does not cover, ``trace`` None).  ``rows`` renders one
    contiguous C-lane pixel slice (``build_rows_renderer``); the frame pads
    to ``n_pad = n_shards * C`` with C a multiple of 128, so block-granular
    bounce compaction stays live per shard."""
    if trace is None or static.gi_enabled or static.dof or static.stereo or not supports(static):
        return None
    n_shards = len(_plan(mesh)[0])
    n = static.width * static.height
    n_pad = n + (-n) % (n_shards * BOUNCE_BLOCK)
    C = n_pad // n_shards
    return build_rows_renderer(static, static.width, static.height, C, trace=trace), C, n_pad


def _fused_trace_fns(static: SceneStatic, trace=round0):
    """The kernel-backed tracers of the per-shard sampler: (trace_fn,
    gi_trace_fn), each possibly None (then ``render_samples`` keeps the
    twin's tracer).

    * ``trace_fn(packed, orig, dir, stats=None)``: ``flagship.trace_rays``,
      K1's ray-input form through ``trace`` (its call decided per batch by
      ``flagship.round0_call``, so gradients take the residual form), the
      deferred texels and the bounce rounds (``build_bounce_finisher(...,
      is_slab=True)``, cached per ray-batch width: shard width or
      chunk-slab width), for Whitted scenes K1 covers (DoF and stereo
      included).  ``stats`` is accepted and not counted, as in JAX;
    * ``gi_trace_fn(packed, orig, dir, key)``: the fused GI tracer
      (``ops/gi.build_gi_tracer``, which takes any ray-batch width, so one
      serves every width) for the GI scenes it covers.

    Float64 rays go to the twin (``trace_whitted`` / ``trace_path``)."""
    from ..ops import flagship as F
    from ..ops.gi import build_gi_tracer
    from ..ops.round0 import layout
    from ..render.pipeline import trace_path, trace_whitted

    W, H = static.width, static.height
    trace_fn = gi_trace_fn = None
    if not static.gi_enabled and supports(static):
        lay = layout(static, W, H)
        finisher = functools.lru_cache(maxsize=None)(lambda n: F.build_bounce_finisher(static, W, H, n, is_slab=True))

        def trace_fn(packed, o3, d3, st=None):
            if o3.dtype != torch.float32:
                return trace_whitted(packed, static, o3, d3, st)
            return F.trace_rays(packed, static, lay, lay.pack(packed), finisher(int(o3.shape[0])),
                                F.round0_call(packed, trace), lambda: (o3, d3))

    if supports_gi(static):
        tracer = build_gi_tracer(static, W, H, trace)

        def gi_trace_fn(packed, o3, d3, key):
            if o3.dtype != torch.float32:
                return trace_path(packed, static, o3, d3, key)
            return tracer(packed, o3, d3, key)

    return trace_fn, gi_trace_fn


def _sampler_setup(static: SceneStatic, n_shards: int, trace):
    """(sample, C, n_pad) of the per-shard sampler: ``sample(i, packed, key,
    st=static, mask=None, base=None)`` renders shard i's C pixels under
    ``fold_in(key, i)``."""
    tf, gtf = _fused_trace_fns(static, trace) if trace is not None else (None, None)
    xf, yf, _ = _pixel_coords(static, n_shards)
    C = xf.shape[0] // n_shards

    def sample(i, packed, key, st=static, mask=None, base=None):
        sl = slice(i * C, (i + 1) * C)
        xs = torch.as_tensor(xf[sl], dtype=packed.dtype, device=packed.device)
        ys = torch.as_tensor(yf[sl], dtype=packed.dtype, device=packed.device)
        return _sample_pixels(packed, st, xs, ys, prng.fold_in(key, i), mask, base, tf, gtf)

    return sample, C, xf.shape[0]


def _replicate(packed: ScenePacked, entries, owned):
    """The scene on the device of every shard this process renders (one
    copy per distinct device)."""
    copies = {}
    for i in owned:
        dev = entries[i]
        if dev not in copies:
            copies[dev] = packed if packed.device == dev else packed.to(dev)
    return {i: copies[entries[i]] for i in owned}


def _gather(render, entries, ranks, owned, C):
    """The padded flat frame from ``render(i) -> [C, 3]`` of every owned
    shard, on the first owned entry's device: concatenated in one process;
    across processes, this rank's slices in a zero frame, summed over every
    rank, so every rank holds the whole frame."""
    home = entries[owned[0]]
    if ranks is None:
        return torch.cat([render(i).to(home) for i in owned])
    parts = {i: render(i) for i in owned}
    any_part = parts[owned[0]]
    flat = torch.zeros((len(entries) * C, 3), dtype=any_part.dtype, device=home)
    for i, part in parts.items():
        flat[i * C:(i + 1) * C] = part.to(home)
    return D.all_reduce_sum(flat)


class _Paths:
    """The per-shard renderers of one scene and mesh, chosen per frame by
    the scene's dtype: the fused rows (deterministic float32 frames of
    covered scenes) or the sampler (everything else)."""

    def __init__(self, static: SceneStatic, mesh, trace):
        self.static = static
        self.entries, self.ranks, self.rows, self.owned = _plan(mesh)
        self.trace = trace
        self.fused = _fused_shard_setup(static, mesh, trace)
        self.adaptive = static.aa_enabled and static.aa_adaptive

    @functools.cached_property
    def sampler(self):
        return _sampler_setup(self.static, len(self.entries), self.trace)

    def pick(self, packed: ScenePacked, key):
        """(shard, base, C, n_pad): ``shard(i, scene, mask=None, base=None)``
        renders shard i (every AA tap; the adaptive taps under ``mask``),
        ``base(i, scene)`` its base tap alone."""
        if self.fused is not None and packed.dtype == torch.float32:
            rows, C, n_pad = self.fused

            def shard(i, scene, mask=None, base=None):
                return rows(scene, i * C, mask=mask, base=base)

            return shard, (lambda i, scene: rows.tap(scene, i * C)), C, n_pad
        sample, C, n_pad = self.sampler
        static_base = dataclasses.replace(self.static, aa_enabled=False)

        def shard(i, scene, mask=None, base=None):
            return sample(i, scene, key, mask=mask, base=base)

        return shard, (lambda i, scene: sample(i, scene, key, static_base)), C, n_pad

    def gather(self, render, C):
        return _gather(render, self.entries, self.ranks, self.owned, C)

    def mask(self, base_of, scenes, C):
        """The whole frame's needs-AA mask from the gathered base taps."""
        with torch.no_grad():
            return _mask_from_base(self.gather(lambda i: base_of(i, scenes[i]), C), self.static)


def make_sharded_render_fn(static: SceneStatic, mesh, trace=round0):
    """``fn(packed, key=None) -> [H, W, 3]`` on the first entry this process
    renders, the pixels sharded over the mesh (see the module docstring).
    ``key`` (a threefry key, None is ``PRNGKey(0)``) seeds the Monte-Carlo
    frames, folded per shard.  ``trace`` is K1's call (``round0``, or its
    plain version ``round0_reference``); None renders every frame through
    the sampler with the twin's tracers (the JAX package's XLA sampler)."""
    paths = _Paths(static, mesh, trace)

    def fn(packed: ScenePacked, key=None):
        key = prng.as_key(key)
        scenes = _replicate(packed, paths.entries, paths.owned)
        shard, base_of, C, _ = paths.pick(packed, key)
        if not paths.adaptive:
            flat = paths.gather(lambda i: shard(i, scenes[i]), C)
        else:
            base = paths.gather(lambda i: base_of(i, scenes[i]), C)
            mask = _mask_from_base(base, static)

            def taps(i):
                sl = slice(i * C, (i + 1) * C)
                dev = paths.entries[i]
                return shard(i, scenes[i], mask=mask[sl].to(dev), base=base[sl].to(dev))

            flat = paths.gather(taps, C)
        return _frame_from_samples(flat, static)

    return fn


def render_frame_distributed(packed: ScenePacked, static: SceneStatic, mesh=None, key=None):
    """One-shot sharded render."""
    mesh = mesh if mesh is not None else make_mesh()
    return make_sharded_render_fn(static, mesh)(packed, key)


def _add(a, b):
    """``a + b`` elementwise over two [loss, *grads] lists, None where a
    leaf has no gradient."""
    return [x if y is None else (y if x is None else x + y) for x, y in zip(a, b)]


def _sum_grads(per_shard, rows, n_shards):
    """Sum the [loss, *grads] lists of this process's shards (``per_shard``
    maps the owned shard indices to them): within each host row first, then
    over rows."""
    cols = n_shards // rows
    total = None
    for h in range(rows):
        row = None
        for i in range(h * cols, (h + 1) * cols):
            if i in per_shard:
                row = per_shard[i] if row is None else _add(row, per_shard[i])
        if row is not None:
            total = row if total is None else _add(total, row)
    return total


def make_sharded_value_and_grad(static: SceneStatic, mesh, trace=round0):
    """``fn(packed, target_hw3, key=None) -> (loss, grads)`` for inverse
    rendering: the pixel-sharded forward, one backward per shard, and the
    shards' losses and parameter gradients summed (per host row, then over
    rows, then over processes: every rank gets the sums), on the first
    entry this process renders.  loss = mean squared error against the
    target frame; ``grads`` is a ScenePacked of gradients (zeros where a
    leaf has none).  ``key`` and ``trace`` as in
    ``make_sharded_render_fn``.

    Under adaptive AA the mask comes from a separate forward base pass
    without a graph; each shard re-renders its base tap inside the graph,
    so unflagged pixels keep their gradient."""
    paths = _Paths(static, mesh, trace)
    n = static.width * static.height
    n_shards = len(paths.entries)

    def fn(packed: ScenePacked, target, key=None):
        key = prng.as_key(key)
        home = paths.entries[paths.owned[0]]
        dt = packed.dtype
        scenes = _replicate(packed, paths.entries, paths.owned)
        shard, base_of, C, n_pad = paths.pick(packed, key)
        pad = n_pad - n
        tflat = torch.cat([target.reshape(-1, 3).to(home, dt), torch.zeros((pad, 3), dtype=dt, device=home)])
        # the weight zeroes the pad lanes, so they do not reach the loss
        weight = torch.cat([torch.ones(n, dtype=dt, device=home), torch.zeros(pad, dtype=dt, device=home)])
        mask = paths.mask(base_of, scenes, C) if paths.adaptive else None
        per_shard = {}
        for i in paths.owned:
            dev = paths.entries[i]
            sl = slice(i * C, (i + 1) * C)
            xs = [x.detach().requires_grad_(x.is_floating_point()) for x in leaves(scenes[i])]
            img = shard(i, from_leaves(xs), mask=mask[sl].to(dev) if mask is not None else None)
            shard_loss = ((img - tflat[sl].to(dev)) ** 2 * weight[sl].to(dev)[:, None]).sum() / (n * 3)
            wanted = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(shard_loss, wanted, allow_unused=True))
            grads = [next(got) if x.requires_grad else None for x in xs]
            per_shard[i] = [shard_loss.detach().to(home)] + [None if g is None else g.to(home) for g in grads]
        total = _sum_grads(per_shard, paths.rows, n_shards)
        if paths.ranks is not None:
            total = _all_reduce_lists(total, leaves(packed), home)
        loss = total[0]
        out = [torch.zeros_like(x, device=home) if g is None else g for x, g in zip(leaves(packed), total[1:])]
        return loss, from_leaves(out)

    return fn


def _all_reduce_lists(total, like, home):
    """[loss, *grads] summed over every process by one all-reduce of a flat
    buffer; a leaf without a gradient here contributes zeros."""
    loss = total[0]
    parts = [loss.reshape(1)]
    for g, x in zip(total[1:], like):
        if x.is_floating_point():
            parts.append((torch.zeros(x.shape, dtype=loss.dtype, device=home) if g is None
                          else g.to(loss.dtype)).reshape(-1))
    flat = D.all_reduce_sum(torch.cat(parts))
    out, at = [flat[0]], 1
    for g, x in zip(total[1:], like):
        if x.is_floating_point():
            out.append(flat[at:at + x.numel()].reshape(x.shape).to(x.dtype))
            at += x.numel()
        else:
            out.append(g)
    return out
