"""The stage probes of the round-0 kernel (K3): where a tap's time goes.

Counterpart of demos/kernel_probe.py ``build_stage`` in the JAX package:
four cut copies of K1, each stopping after one stage and writing two f32
rows of one value per pixel of the frame:

    empty   the lane index times the aa offset's x, and that plus 1 (the
            grid and store floor; compare at a nonzero offset)
    raygen  dx + dy, and dz + ox + oy + oz of the pinhole ray
    scan    the closest hit's t, and win + u (nx where no node has UVs)
    shadow  the number of lights the hit point sees (missed lanes shade
            from t = 0, as in the whole kernel), and t

The JAX probe's ``run`` returns only the sum of the two rows; here the rows
themselves come back, so a stage can be held against its plain version
lane by lane.

* ``round0_stage`` is the wrapper: on a CUDA tensor it launches
  csrc/round0.cu compiled with ``-DC2RT_STAGE=k`` (the same device code as
  K1 with an early return, so registers, stack and time are the stage's
  own), on a CPU tensor it runs the plain version, nothing else.
* ``round0_stage_reference`` is the plain PyTorch version, built from the
  same pieces as ``round0_reference``.

chip_smoke.py's ``ladder`` times every stage and the whole K1 on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .round0 import EPS_SHADOW, H_LIST_CAP, PROGRAM_VERSION, Round0Layout, _check, _node_scans, _raygen, list_scratch

STAGES = ("empty", "raygen", "scan", "shadow")

# kernel launches made by ``round0_stage`` (the CUDA path only), per stage
launches = dict.fromkeys(STAGES, 0)


def _stage(stage: str) -> str:
    if stage not in STAGES:
        raise ValueError(f"round0_stage: stage must be one of {STAGES}, got {stage!r}")
    return stage


def round0_stage_reference(lay: Round0Layout, prm: torch.Tensor, stage: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of one stage probe: the two [width *
    height] f32 rows (see the module docstring)."""
    _stage(stage)
    static, off = lay.static, lay.off
    n = lay.width * lay.height
    device = prm.device

    def p(k):
        return prm[k]

    if stage == "empty":
        v = torch.arange(n, dtype=torch.int32, device=device).to(torch.float32) * p(off["aa"])
        return v, v + 1.0
    ox, oy, oz, dx, dy, dz = _raygen(p, off, lay.width, lay.height, n, device)
    if stage == "raygen":
        return dx + dy, dz + ox + oy + oz
    _, node_min_dist, scene_scan = _node_scans(p, static, off, lay.expr_tables)
    hit, win = scene_scan(ox, oy, oz, dx, dy, dz)
    if stage == "scan":
        return hit["t"], win.to(torch.float32) + hit.get("u", hit["nx"])
    hitmask = win >= 0
    ts = torch.where(hitmask, hit["t"], 0.0)
    hpx, hpy, hpz = ox + dx * ts, oy + dy * ts, oz + dz * ts
    ndotd = dx * hit["nx"] + dy * hit["ny"] + dz * hit["nz"]
    sgn = torch.where(ndotd < 0, 1.0, -1.0)
    sx = hpx + hit["nx"] * sgn * EPS_SHADOW
    sy = hpy + hit["ny"] * sgn * EPS_SHADOW
    sz = hpz + hit["nz"] * sgn * EPS_SHADOW
    acc = torch.zeros(n, dtype=torch.float32, device=device)
    for li in range(static.n_lights):
        lbase = off[f"light{li}"]
        tx2, ty2, tz2 = p(lbase) - sx, p(lbase + 1) - sy, p(lbase + 2) - sz
        target = torch.sqrt(torch.clamp_min(tx2 * tx2 + ty2 * ty2 + tz2 * tz2, 1e-30))
        inv_t = 1.0 / target
        sdx, sdy, sdz = tx2 * inv_t, ty2 * inv_t, tz2 * inv_t
        occ = torch.zeros(n, dtype=torch.bool, device=device)
        for i in range(len(static.nodes)):
            occ = occ | (node_min_dist(i, sx, sy, sz, sdx, sdy, sdz) <= target)
        acc = acc + torch.where(occ, 0.0, 1.0)
    return acc, hit["t"]


def round0_stage(lay: Round0Layout, prm: torch.Tensor, stage: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stage probe of K1 over the whole frame, ``prm = lay.pack(packed,
    aa_offset)``: the two [width * height] f32 rows.  ``prm`` on a CUDA
    device launches the stage's build of csrc/round0.cu (or raises); on the
    CPU it runs ``round0_stage_reference``.  There is no fallback."""
    _stage(stage)
    if prm.device.type == "cpu":
        return round0_stage_reference(lay, prm, stage)
    if prm.device.type != "cuda":
        raise RuntimeError(f"round0_stage: no kernel for device {prm.device}")
    from .. import cuda_build

    dev = prm.device
    _check("prm", prm, torch.float32, (lay.n_prm,), dev)
    n = lay.width * lay.height
    name = f"round0_{stage}"
    lib = cuda_build.load(name)
    if lib.c2rt_program_version() != PROGRAM_VERSION or lib.c2rt_stage() != cuda_build.STAGES[stage]:
        raise RuntimeError(f"round0_stage: the {stage} build of csrc/round0.cu is not the one expected")
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    lists = list_scratch(lay, n, dev)
    cuda_build.launch(name, "c2rt_round0", dev, prm.data_ptr(), lay.program_on(dev).data_ptr(), lay.n_prm,
                      lay.program.size, int(lay.program[H_LIST_CAP]), None, None,
                      None if lists is None else lists.data_ptr(), out.data_ptr(), None, n, lay.width, lay.height)
    launches[stage] += 1
    return out[0], out[1]

