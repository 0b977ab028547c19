"""The CSG stress scenes against the JAX package's plain (XLA) path.

``scenes.csg_stress_scene`` builds the scenes that load K1's CSG hit lists
the most: ``deep16`` (a 16-hit union), ``nested_diff`` (CsgDiff inside
CsgDiff on both sides), ``deep40`` (a 40-hit union of 39 instructions) and
``diff_nest`` (17 spheres under nested CsgDiffs, 33 instructions).  The JAX
Pallas kernel in interpret mode takes too long to compile for them, so here the
port's plain version ``round0_reference`` is held to the JAX package's
non-Pallas path on the same rays: ``ops.geometry.scene_closest`` (winner,
distance, raw normal, UVs) and ``ops.geometry.test_visibility`` (the shadow
bit) from the faceforward-offset hit point, as ``ops.shade.shade_direct``
takes it.  tests/test_torch_kernel_host.py holds the kernel's device code
to that plain version on the same scenes, which anchors it to the JAX
package.  The JAX side of the two long scenes runs eagerly: XLA takes
minutes to compile their networks.

Rays: the 32x24 screen tap's own (made by the JAX camera) and seeded rays
scattered through the scene.  Limits: the repo's kernel-vs-reference limits
(tests/test_fuzz.py): ``win`` differs on < 1% of lanes; over the lanes where
it agrees, < 1% of lanes above 2e-3 and a median below 2e-4 per row; the 0/1
shadow bit differs on < 1% of those lanes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops import geometry as G
from chess2rt_tpu.ops.camera import begin_frame, screen_rays
from chess2rt_tpu.ops.shade import faceforward, shadow_eps
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.scenes import csg_stress_scene

from torch_port_cases import AA, H, W, assert_round0_close, seeded_rays, to_numpy

torch.set_num_threads(2)


def _rays(jp, form):
    if form == "scattered":
        return seeded_rays(11, W * H, center=(0.0, 1.0, 0.0), spread=6.0)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    frame = begin_frame(jp.camera, W / H)
    orig, dir = screen_rays(jp.camera, frame, float(W), float(H), jnp.asarray(xs.reshape(-1) + AA[0]),
                            jnp.asarray(ys.reshape(-1) + AA[1]))
    return np.asarray(orig, np.float32), np.asarray(dir, np.float32)


def _jax_plain(static, jp, orig, dir):
    hit, win = G.scene_closest(jp, static, orig, dir)
    shade_from = hit["p"] + faceforward(dir, hit["normal"]) * shadow_eps(dir.dtype)
    out = {"win": win, "t": hit["dist"], "u": hit["u"], "v": hit["v"],
           **{k: hit["normal"][..., j] for j, k in enumerate(("nx", "ny", "nz"))}}
    for li in range(static.n_lights):
        to = jnp.broadcast_to(jp.light_pos[li], shade_from.shape)
        out[f"vis{li}"] = G.test_visibility(jp, static, shade_from, to).astype(jnp.float32)
    return out


FORMS = ("tap_rays", "scattered")
LONG = ("deep40", "diff_nest")


@functools.lru_cache(maxsize=None)
def _both_sides(kind):
    """(port's plain version, JAX XLA path, port's static) on both ray sets
    of one scene, one after the other: one JAX compile per scene."""
    jp, js = jax_pack_scene(csg_stress_scene(JT, kind, W, H), dtype=jnp.float32)
    tp, ts = torch_pack_scene(csg_stress_scene(TT, kind, W, H), device="cpu")
    orig, dir = (np.concatenate(x) for x in zip(*[_rays(jp, form) for form in FORMS]))
    if kind in LONG:
        with jax.disable_jit():
            ref = to_numpy(_jax_plain(js, jp, jnp.asarray(orig), jnp.asarray(dir)))
    else:
        ref = to_numpy(jax.jit(functools.partial(_jax_plain, js))(jp, jnp.asarray(orig), jnp.asarray(dir)))
    lay = R.layout(ts, W, H, want_hit=True, want_vis=True)
    out = to_numpy(R.round0_reference(lay, lay.pack(tp), torch.from_numpy(orig), torch.from_numpy(dir)))
    return out, ref, ts


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", ["deep16", "nested_diff", *LONG])
def test_plain_version_matches_jax_xla_path(kind, form):
    out, ref, ts = _both_sides(kind)
    lanes = slice(FORMS.index(form) * W * H, (FORMS.index(form) + 1) * W * H)
    out, ref = {k: v[lanes] for k, v in out.items()}, {k: v[lanes] for k, v in ref.items()}

    # the rays reach every node, and miss
    assert set(ref["win"].tolist()) == set(range(-1, len(ts.nodes)))
    hit = ref["win"] >= 0
    # the distance on every lane (1e30 where the ray misses), the raw normal where it hits
    assert_round0_close(out, ref, ["t"])
    on_hits = {k: v[hit] for k, v in out.items()}, {k: v[hit] for k, v in ref.items()}
    assert_round0_close(*on_hits, ["nx", "ny", "nz"])
    # UVs where the winning node's records carry them (the port writes none elsewhere)
    uv_nodes = [i for i, ns in enumerate(ts.nodes) if R._needs_uv(ns)]
    with_uv = np.isin(ref["win"], uv_nodes)
    assert uv_nodes and with_uv.any()
    assert_round0_close({k: v[with_uv] for k, v in out.items()}, {k: v[with_uv] for k, v in ref.items()}, ["u", "v"])
    # the shadow bit where both hit the same node
    agree = hit & (out["win"] == ref["win"])
    for li in range(ts.n_lights):
        k = f"vis{li}"
        assert set(np.unique(out[k])) <= {0.0, 1.0}
        assert (out[k][agree] != ref[k][agree]).mean() < 0.01, k
        assert 0.0 < ref[k][agree].mean() < 1.0  # lit and shadowed lanes both
