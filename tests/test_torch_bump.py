"""Bump maps in the port (the BumpTexture extension): packing, the tangent
frames of the geometry and of the leaf-pinned record, ``apply_bump``,
``reconstruct_tangents`` and the eager Whitted twin, each against the JAX
package on the same seeded inputs.

The scene is ``scenes.bump_scene``, the JAX package's bump scene
(tests/test_bump.py: a plane, a sphere, a scaled and translated cube and a
CsgDiff, every tangent case the reference computes).  Float64 comparisons
run under ``x64`` (restored after); the f64 twin is held u8-exact to the
port's oracle, as tests/test_bump.py:143-147 holds the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops import geometry as JG
from chess2rt_tpu.ops import pallas_grad as JPG
from chess2rt_tpu.ops import shade as JS
from chess2rt_tpu.render.pipeline import render_frame as jax_render_frame
from chess2rt_tpu_torch import oracle as port_oracle
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import from_numpy, pack_scene as torch_pack_scene, to_numpy
from chess2rt_tpu_torch.ops import bump_round0 as B
from chess2rt_tpu_torch.ops import geometry as G
from chess2rt_tpu_torch.ops import round0_grad as RG
from chess2rt_tpu_torch.ops import shade as S
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import bump_scene

from torch_port_cases import assert_frame_close, jax_leaves, u8, x64

torch.set_num_threads(2)

BW, BH = 64, 48


def _pair(dtype=np.float32, mirror=False, bump_csg=True, T_j=JT, T_t=TT):
    """(jax_packed, jax_static, torch_packed, torch_static) of the bump scene."""
    jp, js = jax_pack_scene(bump_scene(T_j, BW, BH, mirror=mirror, bump_csg=bump_csg, aa=False),
                            dtype=jnp.float64 if dtype == np.float64 else jnp.float32)
    tp, ts = torch_pack_scene(bump_scene(T_t, BW, BH, mirror=mirror, bump_csg=bump_csg, aa=False),
                              dtype=torch.float64 if dtype == np.float64 else torch.float32, device="cpu")
    return jp, js, tp, ts


def _rays(n=512, seed=7, dtype=np.float64):
    """Rays from above the scene towards it (tests/test_bump.py:103-107)."""
    rng = np.random.default_rng(seed)
    orig = np.array([[0, 80, -150.0]]) + rng.normal(0, 20, (n, 3))
    tgt = rng.normal(0, 60, (n, 3)) + np.array([[0, 20, 0.0]])
    d = tgt - orig
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return orig.astype(dtype), d.astype(dtype)


@pytest.mark.parametrize("bump_csg", [True, False])
def test_pack_scene_matches_jax(bump_csg):
    jp, js, tp, ts = _pair(bump_csg=bump_csg)
    assert ts.has_bump and ts.bump_sizes == js.bump_sizes == ((32, 32),)
    assert [n.bump_idx for n in ts.nodes] == [n.bump_idx for n in js.nodes]
    assert ts.nodes[3].bump_idx == (0 if bump_csg else -1)
    for name in ("bump_atlas", "bump_scaling", "bump_strength"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)
    # the JAX package's leaves carry across, bump leaves included
    back = to_numpy(from_numpy(jax_leaves(jp), ts, device="cpu"))
    np.testing.assert_array_equal(back["bump_atlas"], np.asarray(jp.bump_atlas))


def test_reference_textures_in_the_bump_slot_do_nothing():
    """A plain BitmapTexture as a node's bump map packs no bump (the
    reference's modifyNormal is a no-op for it, texture.d:10-12)."""
    sc = bump_scene(TT, 16, 12, mirror=False, aa=False)
    for n in sc.nodes:
        if n.bumpmap is not None:
            n.bumpmap = TT.BitmapTexture(name="plain", scaling=0.05, data=n.bumpmap.data)
    _, ts = torch_pack_scene(sc, device="cpu")
    assert not ts.has_bump and ts.bump_sizes == ()


def test_scene_closest_tangents_match_jax():
    """scene_closest(tangents=True) in float64: the winner, normal and the
    dNdx/dNdy frame on every hit lane (the cube's projected-space literals,
    the forward-matrix transform), and the cube quirk itself."""
    orig, dir = _rays()
    with x64():
        jp, js, tp, ts = _pair(np.float64)
        hj, wj = jax.jit(lambda p, o, d: JG.scene_closest(p, js, o, d, tangents=True))(
            jp, jnp.asarray(orig), jnp.asarray(dir))
        hj = {k: np.asarray(v) for k, v in hj.items()}
        wj = np.asarray(wj)
    ht, wt = G.scene_closest(tp, ts, torch.from_numpy(orig), torch.from_numpy(dir), tangents=True)
    np.testing.assert_array_equal(wt.numpy(), wj)
    m = wj >= 0
    assert m.sum() > 100 and len(set(wj[m])) == 4
    for k in ("normal", "dndx", "dndy", "u", "v"):
        np.testing.assert_allclose(ht[k].numpy()[m], hj[k][m], atol=1e-9, err_msg=k)
    rec = G.cube_closest(torch.zeros(3), torch.tensor(10.0), torch.tensor([[-50.0, 0, 0], [0, 0, -50.0]]),
                         torch.tensor([[1.0, 0, 0], [0, 0, 1.0]]), tangents=True)
    np.testing.assert_allclose(rec["dndx"].numpy(), [[1, 0, 0], [1, 0, 0]])


def test_leaf_pinned_record_tangents_match_jax():
    """leaf_pinned_record(tangents=True) at the same pins: the closed-form
    frame per pinned leaf (plane, sphere, transformed cube face, the CSG's
    spheres) against the JAX package's, and against scene_closest's."""
    orig, dir = _rays(seed=8)
    with x64():
        jp, js, tp, ts = _pair(np.float64)
        o, d = torch.from_numpy(orig), torch.from_numpy(dir)
        hit, win = G.scene_closest(tp, ts, o, d, tangents=True)
        gleaf, sel = RG.compute_leaf_pins(tp, ts, o, d, win, hit["dist"])
        n_pin = hit["normal"]
        rt = RG.leaf_pinned_record(tp, ts, o, d, gleaf, sel, n_pin, tangents=True)
        rj = jax.jit(lambda p, oo, dd, g, s, n: JPG.leaf_pinned_record(p, js, oo, dd, g, s, n, tangents=True))(
            jp, jnp.asarray(orig), jnp.asarray(dir), jnp.asarray(gleaf.numpy()), jnp.asarray(sel.numpy()),
            jnp.asarray(n_pin.numpy()))
        rj = {k: np.asarray(v) for k, v in rj.items()}
    m = win.numpy() >= 0
    for k in ("normal", "dndx", "dndy", "u", "v"):
        np.testing.assert_allclose(rt[k].numpy()[m], rj[k][m], atol=1e-9, err_msg=k)
        np.testing.assert_allclose(rt[k].numpy()[m], hit[k].numpy()[m], atol=1e-7, err_msg=k)


def test_apply_bump_matches_jax():
    """apply_bump on scene_closest's records in float32: the bumped normals
    of every hit lane against the JAX package's, and nodes without a bump
    map (the un-bumped CSG node) keep theirs."""
    orig, dir = _rays(seed=9, dtype=np.float32)
    jp, js, tp, ts = _pair(bump_csg=False)
    hj, wj = JG.scene_closest(jp, js, jnp.asarray(orig), jnp.asarray(dir), tangents=True)
    nj = np.asarray(JS.apply_bump(jp, js, jnp.maximum(wj, 0), hj))
    rec = {k: torch.from_numpy(np.array(v)) for k, v in hj.items()}
    winc = torch.from_numpy(np.maximum(np.asarray(wj), 0))
    nt = S.apply_bump(tp, ts, winc, rec).numpy()
    m = np.asarray(wj) >= 0
    np.testing.assert_allclose(nt[m], nj[m], atol=2e-6)
    plain = m & (np.asarray(wj) == 3)
    assert plain.any()
    np.testing.assert_array_equal(nt[plain], np.asarray(hj["normal"])[plain])
    assert np.abs(nt[m] - np.asarray(hj["normal"])[m]).max() > 1e-2  # the bump bites


def test_reconstruct_tangents_match_jax_on_live_lanes():
    """reconstruct_tangents from the raw normals of the winning hits: the
    JAX package's frame on every lane whose winner is a bump-mapped single
    primitive.  On those lanes the cube face's sign from the dominant
    component (the port's) equals the JAX package's sign of the sum."""
    orig, dir = _rays(n=2048, seed=10, dtype=np.float32)
    jp, js, tp, ts = _pair(bump_csg=False)
    hit, win = G.scene_closest(tp, ts, torch.from_numpy(orig), torch.from_numpy(dir))
    winc = torch.clamp_min(win, 0)
    xt, yt = B.reconstruct_tangents(tp, ts, winc, hit["normal"])
    xj, yj = JPG.reconstruct_tangents(jp, js, jnp.asarray(winc.numpy()), jnp.asarray(hit["normal"].numpy()))
    live = (win >= 0).numpy() & np.isin(win.numpy(), [0, 1, 2])
    cube = live & (win.numpy() == 2)
    assert cube.sum() > 20 and live.sum() > 500
    np.testing.assert_allclose(xt.numpy()[live], np.asarray(xj)[live], atol=1e-6)
    np.testing.assert_allclose(yt.numpy()[live], np.asarray(yj)[live], atol=1e-6)
    # the dominant component's sign is the sum's on the cube's hits
    n_l = G._norm(hit["normal"] @ tp.node_matrix[2].T).numpy()[cube]
    dom = np.take_along_axis(n_l, np.abs(n_l).argmax(-1)[:, None], -1)[:, 0]
    np.testing.assert_array_equal(np.sign(dom), np.sign(n_l.sum(-1)))
    # and the frame is the one scene_closest(tangents=True) computes
    ht, _ = G.scene_closest(tp, ts, torch.from_numpy(orig), torch.from_numpy(dir), tangents=True)
    np.testing.assert_allclose(xt.numpy()[live], ht["dndx"].numpy()[live], atol=1e-5)
    np.testing.assert_allclose(yt.numpy()[live], ht["dndy"].numpy()[live], atol=1e-5)


def test_f64_twin_u8_exact_against_the_oracle():
    """The bump scene in float64 through render_frame (the twin) is
    u8-exact against the port's float64 oracle (tests/test_bump.py:143-147)."""
    sc = bump_scene(TT, BW, BH, mirror=False, aa=False)
    ref = port_oracle.render_scene(sc)
    tp, ts = torch_pack_scene(sc, dtype=torch.float64, device="cpu")
    img = P.render_frame(tp, ts).numpy()
    np.testing.assert_array_equal(u8(img), u8(ref))


@pytest.mark.parametrize("mirror", [False, True])
def test_f32_twin_matches_jax_xla_frame(mirror):
    """The float32 twin (bump hook, geometric shadow offset, the mirror's
    bounce rounds) against the JAX package's XLA frame."""
    jp, js, tp, ts = _pair(mirror=mirror)
    ref = np.asarray(jax.jit(lambda p: jax_render_frame(p, dataclasses.replace(js, use_pallas=False)))(jp))
    out = P.render_frame_wavefront(tp, ts).numpy()
    assert_frame_close(out, ref)
    d = np.abs(out - ref).max(-1)
    assert (d > 2e-5).mean() < 0.01, (d > 2e-5).mean()
