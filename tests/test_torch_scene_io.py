"""The port's scene loader, BMP codec, native codec and structured log
against the JAX package's host modules they were copied from: the same
text gives the same scene (``pretty()``, packed leaves, static structure),
the same image gives the same bytes, and the loader's errors are the same.
"""

import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.imageio import load_bmp as jax_load_bmp
from chess2rt_tpu.imageio import save_bmp as jax_save_bmp
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.scene import parse_scene_from_file as jax_parse_file
from chess2rt_tpu.scene import parse_scene_from_string as jax_parse
from chess2rt_tpu.utils import structlog as jax_structlog
from chess2rt_tpu_torch import exceptions as E
from chess2rt_tpu_torch import native
from chess2rt_tpu_torch.imageio import load_bmp, load_bmp_file, save_bmp, save_bmp_file
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.scene import parse_scene_from_file, parse_scene_from_string
from chess2rt_tpu_torch.scene.sdlang import parse_sdl
from chess2rt_tpu_torch.scenes import write_standin_sdl
from chess2rt_tpu_torch.utils import structlog
from chess2rt_tpu_torch.utils.color import srgb_u8

from test_bmp import WIKI_BMP_1, WIKI_BMP_2
from torch_port_cases import jax_leaves

torch.set_num_threads(2)

SDL = """
// a lecture4-style scene: checker floor, CSG, transforms, Phong, a mirror
Scene {
    Name "io"
    GlobalSettings { frameWidth 32; frameHeight 24; maxTraceDepth 3; ambientLightColor 0.1 0.1 0.1 }
    Camera { pos 0 165 0; pitch -30; fov 90 }
    Lights { PointLight { name "l"; pos -30 100 250; color 1 1 1; power 50000 } }
    Geometries {
        Plane "floor" { y 2 }
        Sphere { name "s"; center 0 40 200; R 30 }
        Cube { name "c"; center 10 40 190; side 40 }
        CsgDiff { name "d"; left "c"; right "s" }
        Sphere { name "m"; center 80 50 260; R 25 }
    }
    Textures {
        Checker { name "chk"; color1 1 1 1; color2 0 0.5 1; size 5 }
        Procedure2 { name "p2"; colorU { 0.7 0.1 0.2; 0.3 0.4 0.9; 0.5 0.8 0.1 } freqU 0.01 0.25 0.01
                     colorV { 0.5 0.8 0.1; 0.2 0.2 0.2; 0.1 0.1 0.1 } freqV 0.1 0.2 0.3 }
    }
    Shaders {
        Lambert { name "floor"; texture "chk" }
        Phong { name "ph"; color 0.8 0.3 0.2; exponent 60; strength 1; texture "p2" }
        Reflection { name "mir"; color 0.9 0.9 0.9 }
    }
    Nodes {
        Node { name "floor"; geometry "floor"; shader "floor" }
        Node { name "csg"; geometry "d"; shader "ph"; translate 5 0 10 }
        Node { name "mirror"; geometry "m"; shader "mir"; scale 1.2 1 1 }
    }
}
"""

JSON = json.dumps({
    "Name": "io_json",
    "GlobalSettings": {"frameWidth": 32, "frameHeight": 24, "AAEnabled": False, "adaptiveAA": True},
    "Camera": {"pos": [0, 150, -20], "yaw": 5, "pitch": -25, "fov": 80},
    "Lights": [{"type": "PointLight", "name": "l", "pos": [30, 200, 100], "color": [1, 0.9, 0.8], "power": 60000}],
    "Geometries": [
        {"type": "Plane", "name": "floor", "y": 0},
        {"type": "Sphere", "name": "a", "center": [0, 30, 150], "R": 30},
        {"type": "Cube", "name": "b", "center": [0, 30, 150], "side": 45},
        {"type": "CsgInter", "name": "ab", "left": "a", "right": "b"},
    ],
    "Textures": [{"type": "Procedure2", "name": "p", "colorU": [[0.5, 0.1, 0.1], [0.1, 0.5, 0.1], [0.1, 0.1, 0.5]],
                  "colorV": [[0.2, 0.2, 0.2], [0.1, 0.3, 0.1], [0.3, 0.1, 0.1]], "freqU": [1, 2, 3],
                  "freqV": [3, 2, 1]}],
    "Shaders": [{"type": "Lambert", "name": "fl", "color": [0.7, 0.7, 0.7], "texture": "p"},
                {"type": "Refraction", "name": "gl", "color": [0.95, 0.95, 0.95], "ior": 1.5}],
    "Nodes": [{"type": "Node", "name": "floor", "geometry": "floor", "shader": "fl"},
              {"type": "Node", "name": "glass", "geometry": "ab", "shader": "gl", "rotate": [1, 2, 1]}],
})


def _assert_same_scene(port_scene, jax_scene):
    """Same dump, same static structure, same packed leaves."""
    assert port_scene.pretty() == jax_scene.pretty()
    tp, ts = pack_scene(port_scene, device="cpu")
    jp, js = jax_pack_scene(jax_scene, dtype=jnp.float32)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    for k, v in jax_leaves(jp).items():
        obj = tp.camera if k.startswith("camera.") else tp
        np.testing.assert_array_equal(getattr(obj, k.split(".")[-1]).numpy(), v, err_msg=k)


@pytest.mark.parametrize("fmt", ["sdl", "json"])
def test_parse_scene_from_string_matches_jax(fmt):
    text = SDL if fmt == "sdl" else JSON
    _assert_same_scene(parse_scene_from_string(text, fmt), jax_parse(text, fmt))


def test_standin_scene_file_round_trip(tmp_path):
    """``scenes.write_standin_sdl`` (two BMP textures beside the scene) loads
    to the same scene in both packages, and to the code-built stand-in's
    structure; the textures come back from their 8-bit sRGB files to within
    two steps of the quantizer (the loader's gamma decode is not the exact
    inverse of the sRGB encoder)."""
    from chess2rt_tpu_torch.models import types as TT
    from chess2rt_tpu_torch.scenes import _bitmap, flagship_standin

    path = write_standin_sdl(str(tmp_path), 32, 24)
    sc = parse_scene_from_file(path)
    _assert_same_scene(sc, jax_parse_file(path))
    code = flagship_standin(TT, 32, 24)
    tp, ts = pack_scene(sc, device="cpu")
    cp, cs = pack_scene(code, device="cpu")
    assert dataclasses.asdict(ts) == dataclasses.asdict(cs)
    rng = np.random.default_rng(5)
    for t, size in enumerate((256, 128)):
        want = srgb_u8(_bitmap(rng, size, size))
        got = srgb_u8(tp.bitmap_atlas[t, :size, :size].numpy())
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 2


def test_sdl_parser_basics():
    doc = parse_sdl(
        """
        // comment
        Scene {
            Name "x"  /* inline */
            Tag 1 2.5 -3 true "s"
            Child "named" { y -0.01 }
        }
        """
    )
    scene = doc.children[0]
    assert scene.name == "Scene"
    assert scene.child("Name").values == ["x"]
    assert scene.child("Tag").values == [1, 2.5, -3, True, "s"]
    assert scene.child("Child").values == ["named"]
    assert scene.child("Child").child("y").values == [-0.01]


def test_rotate_maps_to_scale_quirk():
    sdl = """
    Scene {
        Geometries { Sphere { name "s"; R 1 } }
        Shaders { Lambert { name "m" } }
        Nodes { Node { name "n"; geometry "s"; shader "m"; rotate 2 3 4 } }
    }
    """
    s = parse_scene_from_string(sdl, "sdl")
    np.testing.assert_allclose(s.nodes[0].transform.matrix, np.diag([2.0, 3.0, 4.0]))
    m = parse_scene_from_string(sdl, "sdl", fix_reference_bugs=True).nodes[0].transform.matrix
    np.testing.assert_array_equal(m, jax_parse(sdl, "sdl", fix_reference_bugs=True).nodes[0].transform.matrix)
    np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-12)  # a proper rotation


def test_duplicate_names_raise():
    sdl = 'Scene { Geometries { Sphere { name "s"; R 1 } Sphere { name "s"; R 2 } } }'
    with pytest.raises(E.EntityWithDuplicateName):
        parse_scene_from_string(sdl, "sdl")


def test_unknown_type_and_missing_file():
    with pytest.raises(E.InvalidSceneException):
        parse_scene_from_string('Scene { Geometries { Torus { name "t" } } }', "sdl")
    with pytest.raises(E.SceneNotFoundException):
        parse_scene_from_file("/nonexistent/scene.sdl")
    with pytest.raises(E.InvalidSceneException):
        parse_scene_from_file("/nonexistent/scene.txt")
    with pytest.raises(E.InvalidSceneException):
        parse_scene_from_string("Scene { Unterminated", "sdl")


def test_unknown_texture_ref_is_none():
    s = parse_scene_from_string('Scene { Shaders { Lambert { name "m"; texture "nope" } } }', "sdl")
    assert s.shaders[0].texture is None


def test_sdl_unsupported_constructs_fail_clearly():
    for text, match in (('ns:tag "v"\n', "namespace"), ("date 2015/12/06\n", "Unexpected character"),
                        ("blob [sdf789GSfsb2+3324sf2]\n", "Unexpected character"),
                        ('s "no end\n', "Unterminated"), ("}\n", "Unbalanced")):
        with pytest.raises(E.InvalidSceneException, match=match):
            parse_sdl(text)


def _seeded_image(seed, h, w):
    img = np.random.default_rng(seed).uniform(-0.1, 1.2, (h, w, 3)).astype(np.float32)
    img[0, 0] = (np.nan, np.inf, -np.inf)
    return img


@pytest.mark.parametrize("size", [(24, 32), (33, 47), (1, 1)])
@pytest.mark.parametrize("pad", [False, True])
def test_save_bmp_bytes_match_jax(size, pad):
    """Widths 32 (rows already 4-byte aligned) and 47, 1 (padding when
    ``pad_rows``), out-of-gamut and non-finite values included."""
    img = _seeded_image(7, *size)
    for use_native in (False, True):
        want = jax_save_bmp(img, pad_rows=pad, use_native=use_native)
        assert save_bmp(img, pad_rows=pad, use_native=use_native) == want


def test_native_and_numpy_encoders_are_byte_equal():
    if native.get_lib() is None:
        pytest.skip("no g++ here: the numpy path is the only one")
    assert native._LIB_PATH.startswith(native._BUILD)  # built into the port's build/, not native/
    for size in ((33, 47), (48, 64), (1, 1)):
        img = _seeded_image(3, *size)
        for pad in (False, True):
            assert save_bmp(img, pad_rows=pad, use_native=True) == save_bmp(img, pad_rows=pad, use_native=False)
        np.testing.assert_array_equal(native.srgb_quantize(img), srgb_u8(img))


def test_bmp_load_round_trip(tmp_path):
    img = np.clip(_seeded_image(11, 33, 47), 0, 1)
    img[0, 0] = 0.5
    path = str(tmp_path / "x.bmp")
    save_bmp_file(path, img, pad_rows=True)
    back = load_bmp_file(path)
    assert (back.width, back.height) == (47, 33)
    np.testing.assert_allclose(back.to_float_rgb(), srgb_u8(img).astype(np.float32) / 255.0, atol=1e-6)
    for fixture in (WIKI_BMP_1, WIKI_BMP_2):
        np.testing.assert_array_equal(load_bmp(fixture).pixels_u32, jax_load_bmp(fixture).pixels_u32)


def test_structlog_records_match_jax():
    records = []
    for mod in (structlog, jax_structlog):
        stream = io.StringIO()
        log = mod.StructLogger(stream=stream)
        log.emit("scene_loaded", path="x.sdl", nodes=3)
        records.append([{k: v for k, v in json.loads(line).items() if k != "t"}
                        for line in stream.getvalue().splitlines()])
    assert records[0] == records[1] and records[0]
