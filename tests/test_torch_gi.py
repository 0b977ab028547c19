"""GI frames of the port: the twin (``render/pipeline.trace_path``) against the
JAX package's XLA GI frame under the same key, the statistical checks of
tests/test_gi.py against the port's float64 oracle copy (for the twin and
for the fused GI path), the dispatch order, the command line, and the
environment's GI frames, sharded too.

Scene: ``scenes.gi_standin`` (tests/test_gi.py reads lecture4.sdl, which is
not in the repository; the stand-in is lecture4 plus the same far bounce
wall, a bitmap box and a CSG node, all Lambert), NEE on unless said.

Limits:
* the twin against JAX's XLA frame: f32 ``assert_allclose(atol=5e-4)``, the
  JAX package's bound between its two GI paths (tests/test_gi.py:275); f64
  under JAX's x64: max |d| < 1e-6;
* the per-pixel z-score of tests/test_gi.py:107-127 against the oracle:
  z < 4 on > 97% of pixels;
* the reference semantics (:46-55): exactly black without NEE, in every
  path, and in the oracle; the non-quirk mode darker (:292-302); the Phong
  marker (:320-358); DoF before GI before stereo (:362-385).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.render.pipeline import render_frame as jax_render_frame
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import from_numpy
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import gi, prng
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.oracle.renderer import OracleRenderer
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import gi_standin, write_gi_standin_sdl

from torch_port_cases import jax_leaves, x64

torch.set_num_threads(2)

KEY = 7


def _scene(T, w=16, h=12, paths=4):
    return gi_standin(T, w, h, paths=paths)


def _pack(sc, nee=True, dtype=torch.float32, **knobs):
    tp, ts = torch_pack_scene(sc, dtype=dtype, device="cpu")
    return tp, dataclasses.replace(ts, gi_point_light_direct=nee, **knobs)


def _render(tp, ts, key, twin=False):
    with torch.no_grad():
        return (P.render_frame_wavefront if twin else P.render_frame)(tp, ts, prng.PRNGKey(key)).numpy()


@functools.lru_cache(maxsize=None)
def _jax_frame(dtype):
    """The JAX XLA GI frame (16x12, 4 paths, depth 5, NEE) and the port's
    scene on the JAX leaves."""
    with x64(dtype == "float64"):
        jp, js = jax_pack_scene(_scene(JT), dtype=getattr(jnp, dtype))
        js = dataclasses.replace(js, gi_point_light_direct=True)
        img = np.asarray(jax.jit(lambda p, k: jax_render_frame(p, js, k))(jp, jax.random.PRNGKey(KEY)))
        leaves = jax_leaves(jp)
    _, ts = _pack(_scene(TT), dtype=getattr(torch, dtype))
    return img, from_numpy(leaves, ts, device="cpu"), ts


def test_twin_matches_jax_xla_frame_f32():
    img_j, tp, ts = _jax_frame("float32")
    got = _render(tp, ts, KEY, twin=True)
    assert got.shape == img_j.shape == (12, 16, 3) and img_j.max() > 0.05
    np.testing.assert_allclose(got, img_j, atol=5e-4)


def test_twin_matches_jax_xla_frame_f64():
    img_j, tp, ts = _jax_frame("float64")
    got = _render(tp, ts, KEY)  # float64 frames take the twin
    assert got.dtype == np.float64
    assert np.abs(got - img_j).max() < 1e-6


def test_render_frame_dispatch():
    """f32 all-Lambert GI frames take the fused GI path (K1's want_hit form,
    one call per bounce); a Phong node sends the frame to the twin, f64 too;
    a Whitted-only shader raises as JAX does."""
    tp, ts = _pack(_scene(TT))
    assert R.supports_gi(ts) and not R.supports(ts)
    calls = []

    def count(lay, prm, *rays, **kw):
        calls.append((lay.want_hit, lay.want_vis, rays[0].shape[0]))
        return R.round0(lay, prm, *rays, **kw)

    gi.bounce_rounds = 0
    fused = gi.build_gi_renderer(ts, 16, 12, trace=count)(tp, prng.PRNGKey(KEY))
    assert calls and set(calls) == {(True, False, 192)} and len(calls) == gi.bounce_rounds
    assert len(calls) <= ts.paths_per_pixel * (ts.max_trace_depth + 1)
    np.testing.assert_array_equal(fused.numpy(), _render(tp, ts, KEY))

    sc = _scene(TT)
    sc.nodes[1].shader = TT.Phong(name="ph", color=(0.2, 0.3, 0.8), exponent=20.0, strength=0.5)
    tp2, ts2 = _pack(sc)
    assert not R.supports_gi(ts2)
    gi.bounce_rounds = 0
    _render(tp2, ts2, KEY)
    assert gi.bounce_rounds == 0

    sc.nodes[1].shader = TT.Reflection(name="mirror", color=(0.9, 0.9, 0.9))
    tp3, ts3 = _pack(sc)
    with pytest.raises(NotImplementedError, match="only Lambert"):
        _render(tp3, ts3, KEY)


@functools.lru_cache(maxsize=None)
def _z_inputs():
    """K = 4 oracle renders (16x12, 32 paths, NEE, seeds 200 + i) of the
    scene, as tests/test_gi.py:107-127 makes them."""
    sc = _scene(TT, paths=32)
    gold = np.stack([OracleRenderer(sc, gi_point_light_direct=True, seed=200 + i).render() for i in range(4)])
    return sc, gold


@pytest.mark.parametrize("path", ["twin", "fused"])
def test_per_pixel_z_score_against_the_oracle(path):
    """tests/test_gi.py:107-127: each pipeline's per-pixel noise from K = 4
    renders; the means agree within it on > 97% of pixels."""
    sc, gold = _z_inputs()
    tp, ts = _pack(sc)
    dev = np.stack([_render(tp, ts, 100 + i, twin=path == "twin") for i in range(4)])
    md, mo = dev.mean(0), gold.mean(0)
    se = np.sqrt((dev.var(0) + gold.var(0)) / 4) + 5e-3 + 0.02 * np.abs(mo)
    z = np.abs(md - mo) / se
    assert (z < 4.0).mean() > 0.97, (z.max(), (z >= 4.0).mean())
    assert md.max() > 0.01 and mo.max() > 0.01


def test_reference_semantics_black_without_nee():
    """A point light's solid angle is 0 (light.d:72-75): without NEE the GI
    frame is exactly black, in the fused path, the twin and the oracle."""
    sc = _scene(TT)
    tp, ts = _pack(sc, nee=False)
    assert R.supports_gi(ts)
    np.testing.assert_array_equal(_render(tp, ts, 0), 0.0)
    np.testing.assert_array_equal(_render(tp, ts, 0, twin=True), 0.0)
    np.testing.assert_array_equal(OracleRenderer(sc, seed=3).render(), 0.0)


def test_physical_mode_darker_than_quirk():
    """Dropping the multiplier quirk (renderer.d:356) attenuates the
    indirect bounces: strictly less energy, still some."""
    sc = _scene(TT, 24, 16, paths=32)
    tp, ts = _pack(sc)
    a = _render(tp, ts, 0)
    b = _render(tp, dataclasses.replace(ts, gi_multiplier_quirk=False), 0)
    assert 0 < b.mean() < a.mean()


def _phong_node(center, r=8.0):
    ph = TT.Phong(name=f"ph{center}", color=(0.2, 0.3, 0.8), exponent=20.0, strength=0.5)
    return TT.Node(name=f"phnode{center}", geometry=TT.Sphere(name=f"phg{center}", center=center, R=r), shader=ph)


def test_unhit_phong_node_renders_identically():
    """A Phong node no path reaches changes nothing (the same stream, the
    same winners): the twin with it equals the twin without it."""
    sc = _scene(TT, 24, 16, paths=6)
    tp, ts = _pack(sc)
    ref = _render(tp, ts, 0, twin=True)
    sc.nodes.append(_phong_node((0.0, -5000.0, -5000.0)))
    tp, ts = _pack(sc)
    np.testing.assert_array_equal(_render(tp, ts, 0), ref)


def test_hit_phong_paints_the_red_marker():
    """Paths that hit a Phong node return (1, 0, 0), unscaled: directly
    visible Phong pixels are exactly red, in the twin and in the oracle."""
    sc = _scene(TT, 24, 16, paths=4)
    sc.nodes.append(_phong_node((0.0, 60.0, 150.0), r=55.0))
    tp, ts = _pack(sc)
    img = _render(tp, ts, 0)
    red = (img == np.array([1.0, 0.0, 0.0])).all(-1)
    gold = OracleRenderer(sc, gi_point_light_direct=True, seed=7).render()
    gred = (gold == np.array([1.0, 0.0, 0.0])).all(-1)
    assert red.sum() >= 0.1 * red.size, red.sum()
    assert gred.sum() >= 0.1 * gred.size, gred.sum()
    assert (red & gred).sum() >= 0.8 * max(red.sum(), gred.sum())


def test_dispatch_order_dof_gi_stereo():
    """renderSample: DoF before GI (a GI scene with DoF renders Whitted DoF
    samples: not black without NEE), GI before stereo (a GI scene with a
    stereo camera path-traces mono: black without NEE)."""
    sc = _scene(TT)
    sc.camera.stereoSeparation = 2.0
    tp, ts = _pack(sc, nee=False)
    assert ts.stereo and ts.gi_enabled
    np.testing.assert_array_equal(_render(tp, ts, 0), 0.0)
    sc = _scene(TT)
    sc.camera.dof, sc.camera.numSamples = True, 2
    tp, ts = _pack(sc, nee=False)
    assert ts.dof and ts.gi_enabled and not R.supports_gi(ts)
    assert _render(tp, ts, 0).max() > 0.01


def test_what_gi_still_refuses():
    """Nothing of GI raises any more.  The environment miss term (item 10)
    is ported: the env GI frame renders, on the fused path and in the twin,
    and the sky lights it; so does its sharded frame (item 11)."""
    from chess2rt_tpu_torch.parallel import make_mesh, make_sharded_render_fn

    sc = _scene(TT)
    sc.environment.cubemap = np.full((6, 4, 4, 3), 0.5, dtype=np.float32)
    tp, ts = _pack(sc)
    assert ts.has_env and R.supports_gi(ts)
    lit = _render(tp, ts, 0)
    dark = _render(tp, dataclasses.replace(ts, has_env=False), 0)
    assert np.isfinite(lit).all() and lit.mean() > dark.mean() + 0.05
    np.testing.assert_allclose(_render(tp, ts, 0, twin=True), lit, atol=5e-4)
    miss = P.trace_path(tp, ts, torch.tensor([[0.0, 10.0, 0.0]] * 4), torch.tensor([[0.0, 1.0, 0.0]] * 4),
                        prng.PRNGKey(0))
    np.testing.assert_allclose(miss.numpy(), 0.5)  # straight up into the grey sky
    # the sharded env GI frame (item 11) renders too: the fused GI tracer per
    # shard against the twin's, and the sky lights it
    sharded = make_sharded_render_fn(ts, make_mesh(["cpu", "cpu"]))(tp, prng.PRNGKey(0)).numpy()
    twin = make_sharded_render_fn(ts, make_mesh(["cpu", "cpu"]), trace=None)(tp, prng.PRNGKey(0)).numpy()
    np.testing.assert_allclose(sharded, twin, atol=5e-4)
    assert sharded.mean() > dark.mean() + 0.05


def test_cli_renders_the_gi_scene_file(tmp_path):
    """``python -m chess2rt_tpu_torch --file gi.sdl``: GIEnabled from the file
    reaches the GI path (the fused one: K1's bounce rounds run), and SDL has
    no NEE switch, so the BMP is exactly black, as the reference renders it
    and as this process renders the same file."""
    from chess2rt_tpu_torch import app
    from chess2rt_tpu_torch.imageio.bmp import load_bmp_file
    from chess2rt_tpu_torch.scene.loader import parse_scene_from_file
    from chess2rt_tpu_torch.utils.color import srgb_u8

    path = write_gi_standin_sdl(str(tmp_path), 24, 16, paths=2)
    bmp = str(tmp_path / "out.bmp")
    gi.bounce_rounds = 0
    assert app.main(["--file", path, "-o", bmp, "--device", "cpu", "--seed", "0", "-q"]) == 0
    assert gi.bounce_rounds > 0
    px = load_bmp_file(bmp).pixels_u32
    got = np.stack([(px >> 16) & 0xFF, (px >> 8) & 0xFF, px & 0xFF], axis=-1).astype(np.uint8)
    tp, ts = torch_pack_scene(parse_scene_from_file(path), device="cpu")
    assert ts.gi_enabled and ts.paths_per_pixel == 2 and not ts.gi_point_light_direct
    want = srgb_u8(_render(tp, ts, 0))
    assert got.shape == want.shape == (16, 24, 3)
    np.testing.assert_array_equal(got, want)
    assert not got.any()
