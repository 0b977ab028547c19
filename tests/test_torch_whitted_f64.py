"""Float64 frames of the port: the eager Whitted twin against the JAX
package's XLA frame in float64 (max |d| <= 1e-9), and ``render_frame``'s
float64 frames against the float64 numpy oracle (the JAX package's
``OracleRenderer``), held as tests/test_parity.py:42-66 holds the JAX
package's: u8-exact with max |d| < 1e-6 on CSG-free scenes; with CSG, where
the oracle re-casts rays in 1e-6 steps, max |d| < 1e-4 and u8 equal on
> 99.9% of pixels.  The port's own oracle copy, which the card's checks
use, is held equal to the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.oracle import OracleRenderer
from chess2rt_tpu.render.pipeline import render_frame as jax_render_frame
from chess2rt_tpu_torch import oracle as port_oracle
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import csg_free_scene, csg_stress_scene

from torch_port_cases import H, W, scene, u8, x64

torch.set_num_threads(2)


def _scene(T, case, aa=None):
    if case == "csg_free":
        sc = csg_free_scene(T, 0, W, H)
    elif case in ("deep16", "nested_diff"):
        sc = csg_stress_scene(T, case, W, H)
    else:
        sc = scene(T, case)
    if aa is not None:
        sc.settings.AAEnabled = aa
    return sc


@pytest.mark.parametrize("case,aa", [("standin", False), (1000, True)])
def test_twin_f64_matches_jax_xla_frame(case, aa):
    with x64():
        jp, js = jax_pack_scene(_scene(JT, case, aa), dtype=jnp.float64)
        ref = np.asarray(jax.jit(lambda p: jax_render_frame(p, js))(jp))
    assert ref.dtype == np.float64
    tp, ts = torch_pack_scene(_scene(TT, case, aa), dtype=torch.float64, device="cpu")
    out = P.render_frame_wavefront(tp, ts)
    assert out.dtype == torch.float64
    assert np.abs(out.numpy() - ref).max() <= 1e-9


def _f64_frame(case, aa=None, seed=0):
    sc = csg_free_scene(TT, seed, W, H) if case == "csg_free" else _scene(TT, case, aa)
    tp, ts = torch_pack_scene(sc, dtype=torch.float64, device="cpu")
    img = P.render_frame(tp, ts)  # f64: the twin
    assert img.dtype == torch.float64
    jsc = csg_free_scene(JT, seed, W, H) if case == "csg_free" else _scene(JT, case, aa)
    gold = OracleRenderer(jsc).render()
    np.testing.assert_array_equal(port_oracle.OracleRenderer(sc).render(), gold)  # the port's copy
    return img.numpy(), gold


@pytest.mark.parametrize("case,aa", [("standin", False), ("glass", True), ("nested_diff", False)])
def test_f64_frame_meets_the_oracle_with_csg(case, aa):
    img, gold = _f64_frame(case, aa)
    assert np.abs(img - gold).max() < 1e-4
    assert (u8(img) == u8(gold)).all(-1).mean() > 0.999
    assert (gold.max(-1) > 0).mean() > 0.5


@pytest.mark.parametrize("seed", [0, 1])
def test_f64_frame_is_u8_exact_without_csg(seed):
    """A CSG-free scene (``scenes.csg_free_scene``: checker, procedure2,
    Phong, a transformed cube, a mirror; AA5), as the JAX package's
    lecture4 family is held."""
    img, gold = _f64_frame("csg_free", seed=seed)
    assert np.abs(img - gold).max() < 1e-6
    np.testing.assert_array_equal(u8(img), u8(gold))
    assert len(np.unique(u8(img).reshape(-1, 3), axis=0)) > 100  # a frame with content


def test_f64_frame_renders_with_adaptive_aa_and_slabs():
    """Adaptive AA and ``chunk_pixels`` in f64 meet the oracle's adaptive
    frame (``GlobalSettings.adaptiveAA``) u8-exactly."""
    sc_t, sc_j = csg_free_scene(TT, 0, W, H), csg_free_scene(JT, 0, W, H)
    sc_t.settings.adaptiveAA = sc_j.settings.adaptiveAA = True
    tp, ts = torch_pack_scene(sc_t, dtype=torch.float64, device="cpu")
    assert ts.aa_adaptive
    img = P.render_frame(tp, dataclasses.replace(ts, chunk_pixels=300)).numpy()
    gold = OracleRenderer(sc_j).render()
    assert np.abs(img - gold).max() < 1e-6
    np.testing.assert_array_equal(u8(img), u8(gold))


def _bitmap_scene(T):
    """A bitmap-textured floor and sphere under one light, AA off: the texel
    gradient's scene at 32x24."""
    from chess2rt_tpu_torch.scenes import _bitmap

    rng = np.random.default_rng(3)
    sc = T.Scene(name="bitmaps")
    sc.settings.frameWidth, sc.settings.frameHeight = W, H
    sc.settings.AAEnabled = False
    sc.camera = T.Camera(pos=(0.0, 165.0, 0.0), yaw=0.0, pitch=-20.0, roll=0.0, fov=90.0)
    sc.camera.set_frame_size(W, H)
    sc.lights = [T.PointLight(name="key", pos=(-160.0, 420.0, 120.0), color=(1.0, 0.95, 0.9), power=150000.0)]
    floor_tex = T.BitmapTexture(name="floor_tex", scaling=1.0 / 180.0, data=_bitmap(rng, 16, 16))
    ball_tex = T.BitmapTexture(name="ball_tex", scaling=1.0, data=_bitmap(rng, 8, 8))
    sc.textures = [floor_tex, ball_tex]
    for name, geom, tex in (("floor", T.Plane(name="floor", y=0.0), floor_tex),
                            ("ball", T.Sphere(name="ball", center=(-40.0, 50.0, 220.0), R=50.0), ball_tex)):
        sh = T.Lambert(name=name, color=(1.0, 1.0, 1.0), texture=tex)
        sc.shaders.append(sh)
        sc.geometries.append(geom)
        sc.nodes.append(T.Node(name=name, geometry=geom, shader=sh))
    return sc


def test_f64_texel_gradient_matches_jax_grad():
    """The texel VJP in float64: the twin's frame differentiated in
    ``bitmap_atlas`` (``train_textures`` on) against ``jax.grad`` of the JAX
    XLA frame in x64, |a - b| <= 1e-9 + 1e-6 max|b|.  K2 is f32 only; the
    f64 cotangents take the plain sorted segment sum."""
    target = np.random.default_rng(4).uniform(size=(H, W, 3))
    with x64():
        jp, js = jax_pack_scene(_bitmap_scene(JT), dtype=jnp.float64)
        assert js.train_textures

        def loss(p):
            return ((jax_render_frame(p, js) - jnp.asarray(target)) ** 2).mean()

        want = np.asarray(jax.jit(jax.grad(loss))(jp).bitmap_atlas)
    tp, ts = torch_pack_scene(_bitmap_scene(TT), dtype=torch.float64, device="cpu")
    atlas = tp.bitmap_atlas.detach().clone().requires_grad_()
    tp = dataclasses.replace(tp, bitmap_atlas=atlas)
    ((P.render_frame(tp, ts) - torch.from_numpy(target)) ** 2).mean().backward()
    have = atlas.grad.numpy()
    assert have.dtype == np.float64 and have.shape == want.shape
    assert np.abs(want).max() > 0 and (np.abs(want) > 0).mean() > 0.05
    assert np.abs(have - want).max() <= 1e-9 + 1e-6 * np.abs(want).max()
