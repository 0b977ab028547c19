"""The yardstick of a kernel's roofline share: the card's published peaks and
the work a cell's rays need, counted from the benchmark's own scene
description and never from the program's layout.

The per-ray f32 operation table is a frozen copy of chip_smoke.py's
``OPS_*`` table at commit d735142 (counted by hand from csrc/round0.cu: one
per add, subtract, multiply, divide and sqrt; compares, selects and address
work not counted), rewritten to read a scene packed by the reference's own
packer (``rtbench/reference/packed.py``'s ``SceneStatic``).  The least work
of K1's job, whatever implements it, is counted per ray as a floor:

* every camera and bounce ray scans every node for its closest hit and
  builds the hit point;
* every shadow ray is built, counts the least scan an occluded ray needs
  (one node), and shades one light (Lambert's terms);
* every Whitted bounce ray was spawned by a mirror continuation (a GI
  bounce's hemisphere sample is not K1's work);
* ray-gen, Phong's extra terms and the full scan of unoccluded shadow rays
  are left out, so the count stays below what any implementation does.

Bytes: the scene's parameters read once, each non-camera ray's 24-byte
input (origin and direction), and the frame's output written once.  The ray
counts by kind are fixed per cell in the configuration file, counted by the
reference at the cell's size (``python -m rtbench.count_rays``).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes/s and f32 operations/s outside the
# tensor cores (at the full 700 W power limit)
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

OPS_PLANE = 7
OPS_SPHERE_ROOTS = 32
OPS_SPHERE_RECORD, OPS_SPHERE_UV = 19, 44
OPS_CUBE_SLAB, OPS_CUBE_RECORD, OPS_CUBE_UV = 22, 6, 2
OPS_MATRIX = (69, 44)  # (closest-hit record, dist-only); an offset costs 3
# (the table's ray-gen, 26, and Phong's extra terms, 37, are left out of the floor)
OPS_HITPOINT, OPS_SHADOW_RAY, OPS_LIGHT, OPS_OUT, OPS_CONT = 20, 13, 25, 3, 24

# the reference packer's texture kind "none" (rtbench/reference/packed.py)
TEX_NONE = 0
# leaves that hold textures, which the gathers read and K1 does not
TEXTURE_LEAVES = ("bitmap_atlas", "bump_atlas", "env_cubemap")


def node_ops(static) -> list:
    """[(closest-hit ops, dist-only ops)] per node of a reference
    ``SceneStatic``.  Inside a CSG expression a sphere and a cube give both
    crossings."""

    def leaf(kind, uv, both):
        k = 2 if both else 1
        if kind == "plane":
            return OPS_PLANE, OPS_PLANE
        if kind == "sphere":
            return OPS_SPHERE_ROOTS + k * (OPS_SPHERE_RECORD + uv * OPS_SPHERE_UV), OPS_SPHERE_ROOTS
        return OPS_CUBE_SLAB + k * (OPS_CUBE_RECORD + uv * OPS_CUBE_UV), OPS_CUBE_SLAB

    def walk(expr, uv, both):
        if expr[0] != "csg":
            return leaf(expr[0], uv, both)
        (lh, ld), (rh, rd) = walk(expr[2], uv, True), walk(expr[3], uv, True)
        return lh + rh, ld + rd

    out = []
    for ns in static.nodes:
        uv = int(ns.tex_kind != TEX_NONE or ns.bump_idx >= 0)
        hit, dist = walk(ns.geom, uv, False)
        if not ns.identity_transform:
            xh, xd = (3, 3) if ns.offset_only else OPS_MATRIX
            hit, dist = hit + xh, dist + xd
        out.append((hit, dist))
    return out


def scene_bytes(packed) -> int:
    """Bytes of the scene's parameters (every leaf but the textures)."""
    from .reference.packed import LEAF_NAMES, leaves

    return sum(4 * x.numel() for name, x in zip(LEAF_NAMES, leaves(packed)) if name not in TEXTURE_LEAVES)


def k1_work(static, packed, rays: dict, width: int, height: int):
    """(operations, bytes) of one frame's K1 work: ``rays`` holds the frame's
    camera, shadow and bounce rays."""
    nodes = node_ops(static)
    scan_hit = sum(h for h, _ in nodes)
    scan_one = min(d for _, d in nodes)
    traced = rays["camera"] + rays["bounce"]
    ops = (traced * (scan_hit + OPS_HITPOINT + OPS_OUT)
           + rays["shadow"] * (OPS_SHADOW_RAY + scan_one + OPS_LIGHT)
           + (0 if static.gi_enabled else rays["bounce"] * OPS_CONT))
    n_bytes = scene_bytes(packed) + 24 * rays["bounce"] + 4 * 3 * width * height
    return float(ops), float(n_bytes)


def least_seconds(ops: float, n_bytes: float):
    """(seconds, "operations" | "bytes"): the larger of the two bounds."""
    t_ops, t_bytes = ops / PEAK_F32, n_bytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
