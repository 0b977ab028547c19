"""The port's scene scan against the JAX package's XLA path.

``ops.geometry.scene_closest`` (winner, distance, hit point, raw normal,
UVs) and ``ops.geometry.test_visibility`` (one shadow bit per light, from
the faceforward-offset hit point, as ``shade_direct`` takes it), on seeded
rays scattered through each scene: the stand-in (mirror and glass), the
random scenes 1000-1003 and the two CSG stress scenes.  The JAX side runs
eagerly (op by op; a jit compile per scene costs four times as much here).

Limits: in f32 the repo's kernel-vs-reference limits (tests/test_fuzz.py):
``win`` differs on < 1% of lanes; over the lanes where it agrees, < 1% of
lanes with d > 2e-3 and a median below 2e-4 per output, d relative to the
reference above magnitude 1 (``torch_port_cases.lane_error``); the shadow
bits differ on < 1% of those lanes.  In f64: ``win`` and every shadow bit
equal on every lane, d <= 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops import geometry as JG
from chess2rt_tpu.ops.shade import faceforward as jax_faceforward
from chess2rt_tpu.ops.shade import shadow_eps as jax_shadow_eps
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import geometry as G
from chess2rt_tpu_torch.ops import shade as S
from chess2rt_tpu_torch.scenes import csg_stress_scene

from torch_port_cases import RANDOM_SEEDS, H, W, assert_round0_close, lane_error, rays_for, scene, seeded_rays, x64

torch.set_num_threads(2)

STRESS = ("deep16", "nested_diff")
CASES = ("standin", "glass") + RANDOM_SEEDS + STRESS
N_RAYS = W * H
VEC = {"p": ("px", "py", "pz"), "normal": ("nx", "ny", "nz")}


def _scene(T, case):
    return csg_stress_scene(T, case, W, H) if case in STRESS else scene(T, case)


def _rays(case):
    if case in STRESS:
        return seeded_rays(11, N_RAYS, center=(0.0, 1.0, 0.0), spread=6.0)
    return rays_for(case, N_RAYS)


def _rows(hit, win, vis, to_np):
    out = {"win": to_np(win), "t": to_np(hit["dist"]), "u": to_np(hit["u"]), "v": to_np(hit["v"])}
    for k, names in VEC.items():
        for j, name in enumerate(names):
            out[name] = to_np(hit[k][..., j])
    for li, b in enumerate(vis):
        out[f"vis{li}"] = to_np(b).astype(np.float64)
    return out


def _jax_side(case, f64):
    jdt = jnp.float64 if f64 else jnp.float32
    jp, js = jax_pack_scene(_scene(JT, case), dtype=jdt)
    orig, dir = (jnp.asarray(a, jdt) for a in _rays(case))
    hit, win = JG.scene_closest(jp, js, orig, dir)
    shade_from = hit["p"] + jax_faceforward(dir, hit["normal"]) * jax_shadow_eps(jdt)
    vis = [JG.test_visibility(jp, js, shade_from, jnp.broadcast_to(jp.light_pos[li], shade_from.shape))
           for li in range(js.n_lights)]
    return _rows(hit, win, vis, np.asarray)


def _port_side(case, f64):
    tdt = torch.float64 if f64 else torch.float32
    tp, ts = torch_pack_scene(_scene(TT, case), dtype=tdt, device="cpu")
    orig, dir = (torch.from_numpy(a).to(tdt) for a in _rays(case))
    hit, win = G.scene_closest(tp, ts, orig, dir)
    shade_from = hit["p"] + S.faceforward(dir, hit["normal"]) * S.shadow_eps(tdt)
    vis = [G.test_visibility(tp, ts, shade_from, torch.broadcast_to(tp.light_pos[li], shade_from.shape))
           for li in range(ts.n_lights)]
    assert win.dtype == torch.int32 and hit["dist"].dtype == tdt
    return _rows(hit, win, vis, lambda x: x.numpy()), ts


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_scene_closest_and_visibility_match_jax(case, dtype):
    f64 = dtype == "f64"
    with x64(f64):
        ref = _jax_side(case, f64)
    out, ts = _port_side(case, f64)
    assert set(out) == set(ref)
    hit = ref["win"] >= 0
    assert 0.02 < hit.mean() < 1.0, hit.mean()  # the rays hit and miss
    on_hits = [k for k in out if k not in ("win", "t") and not k.startswith("vis")]
    vis = [f"vis{li}" for li in range(ts.n_lights)]
    if f64:
        np.testing.assert_array_equal(out["win"], ref["win"])
        assert lane_error(out["t"], ref["t"]).max() <= 1e-9
        for k in on_hits:
            assert lane_error(out[k][hit], ref[k][hit]).max() <= 1e-9, k
        for k in vis:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        return
    assert_round0_close(out, ref, ["t"])
    assert_round0_close({k: v[hit] for k, v in out.items()}, {k: v[hit] for k, v in ref.items()}, on_hits)
    agree = hit & (out["win"] == ref["win"])
    for k in vis:
        assert (out[k][agree] != ref[k][agree]).mean() < 0.01, k


def test_empty_scene_misses_every_ray():
    """No node: every ray misses (win -1, dist INF, the record is the ray),
    and every shadow ray is unoccluded, as in the JAX package."""
    sc_t, sc_j = scene(TT, "standin"), scene(JT, "standin")
    sc_t.nodes, sc_j.nodes = [], []
    tp, ts = torch_pack_scene(sc_t, device="cpu")
    jp, js = jax_pack_scene(sc_j, dtype=jnp.float32)
    orig, dir = rays_for("standin", 64)
    hit, win = G.scene_closest(tp, ts, torch.from_numpy(orig), torch.from_numpy(dir))
    jhit, jwin = JG.scene_closest(jp, js, jnp.asarray(orig), jnp.asarray(dir))
    assert (win.numpy() == -1).all() and (np.asarray(jwin) == -1).all()
    for k in ("dist", "p", "normal", "u", "v"):
        np.testing.assert_array_equal(hit[k].numpy(), np.asarray(jhit[k]), err_msg=k)
    assert G.test_visibility(tp, ts, torch.from_numpy(orig), torch.from_numpy(orig) + 1.0).all()
