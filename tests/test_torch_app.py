"""The port's command line (``chess2rt_tpu_torch.app``) against the JAX
package's (``chess2rt_tpu.app``) on the same scene file: the stand-in as
SDL (``scenes.write_standin_sdl``: CSG, two BMP textures, Phong, a scaled
and translated cube, the mirror) at 32x24, AA off.  Both BMPs are decoded:
f64 frames equal in u8 on > 99.9% of pixels; f32 frames at the frame
limits after sRGB (< 1% of pixels differ at all).  Here the port runs with
``--device cpu``; the JAX CLI renders its XLA path on the CPU.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from chess2rt_tpu import app as jax_app
from chess2rt_tpu_torch import app
from chess2rt_tpu_torch.imageio import load_bmp_file
from chess2rt_tpu_torch.scene import parse_scene_from_file
from chess2rt_tpu_torch.scenes import write_standin_sdl

from torch_port_cases import H, W, x64

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    return write_standin_sdl(str(tmp_path_factory.mktemp("scene")), W, H, aa=False)


def _u8(path):
    p = load_bmp_file(path).pixels_u32
    return np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], axis=-1).astype(int)


def _both(scene_file, tmp_path, *flags):
    """Render with both CLIs (the JAX one leaves jax_enable_x64 as it was)."""
    out_t, out_j = str(tmp_path / "port.bmp"), str(tmp_path / "jax.bmp")
    assert app.main(["--file", scene_file, "-o", out_t, "-q", "--device", "cpu", *flags]) == 0
    with x64(False):
        assert jax_app.main(["--file", scene_file, "-o", out_j, "-q", *flags]) == 0
    return _u8(out_t), _u8(out_j)


def test_f32_frame_matches_the_jax_cli(scene_file, tmp_path):
    got, want = _both(scene_file, tmp_path)
    assert got.shape == want.shape == (H, W, 3)
    d = np.abs(got - want).max(-1)
    assert (d > 0).mean() < 0.01, ((d > 0).mean(), d.max())
    assert (want.max(-1) > 0).mean() > 0.5


def test_f64_frame_matches_the_jax_cli(scene_file, tmp_path):
    got, want = _both(scene_file, tmp_path, "--dtype", "f64")
    assert (got == want).all(-1).mean() > 0.999


def test_oracle_backend_writes_the_oracle_frame(scene_file, tmp_path):
    """``--backend oracle``: the port's oracle copy, byte for byte the JAX
    CLI's oracle frame."""
    out_t, out_j = tmp_path / "port.bmp", tmp_path / "jax.bmp"
    assert app.main(["--file", scene_file, "-o", str(out_t), "-q", "--device", "cpu", "--backend", "oracle"]) == 0
    assert jax_app.main(["--file", scene_file, "-o", str(out_j), "-q", "--backend", "oracle"]) == 0
    assert out_t.read_bytes() == out_j.read_bytes()


def _column(text, title):
    """The rows of one column of a --debug-pixel dump, by its title."""
    lines = text.strip().splitlines()
    header = next(i for i, line in enumerate(lines) if "oracle (f64)" in line)
    start = lines[header].index(title)
    stop = lines[header].index("oracle (f64)") if title.startswith("device") else None
    return [line[start:stop].replace("   <- differs", "").strip() for line in lines[header + 1:]]


def test_debug_pixel_oracle_column_matches_the_jax_cli(scene_file, capsys, monkeypatch):
    """The oracle column, text for text.  The JAX CLI's device column is
    given the port's device trace, so that only its oracle side runs (its
    eager device trace of the stand-in takes ~25 s here)."""
    x, y = W // 2, H // 2
    assert app.main(["--file", scene_file, "-q", "--device", "cpu", "--debug-pixel", f"{x},{y}"]) == 0
    port = capsys.readouterr().out
    port_scene = parse_scene_from_file(scene_file)  # the JAX scene's objects are the JAX package's types
    monkeypatch.setattr(jax_app, "_device_pixel_trace",
                        lambda scene, x, y, dtype_str: app._device_pixel_trace(port_scene, x, y, dtype_str, "cpu"))
    assert jax_app.main(["--file", scene_file, "-q", "--debug-pixel", f"{x},{y}"]) == 0
    ref = capsys.readouterr().out
    assert port == ref
    assert port.splitlines()[0] == f"Mouse click at: ({x}, {y})"
    assert len(_column(port, "oracle (f64)")) == 8  # the hit rows and the color: the center pixel hits the mirror


def test_debug_pixel_f64_device_column_is_the_oracle(scene_file, capsys):
    """In f64 the twin's trace prints the oracle's digits, all but the last
    digit of the color (the oracle keeps colors in f32 like the reference)."""
    assert app.main(["--file", scene_file, "-q", "--device", "cpu", "--dtype", "f64",
                     "--debug-pixel", f"{W // 2},{H // 2}"]) == 0
    out = capsys.readouterr().out
    device, oracle = _column(out, "device (f64)"), _column(out, "oracle (f64)")
    assert device[:-1] == oracle[:-1]
    rgb = [np.array(c.strip("()").split(", "), dtype=float) for c in (device[-1], oracle[-1])]
    np.testing.assert_allclose(rgb[0], rgb[1], atol=2e-6)


def test_distributed_flag_writes_the_same_frame(scene_file, tmp_path):
    """``--distributed``: the pixels in slices over a mesh (here one CPU
    entry), the same bytes as the single frame."""
    out_d, out_s = tmp_path / "d.bmp", tmp_path / "s.bmp"
    assert app.main(["--file", scene_file, "-o", str(out_d), "-q", "--device", "cpu", "--distributed"]) == 0
    assert app.main(["--file", scene_file, "-o", str(out_s), "-q", "--device", "cpu"]) == 0
    assert out_d.read_bytes() == out_s.read_bytes()


def test_the_cli_raises_without_a_card(scene_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI renders on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        app.main(["--file", scene_file, "-o", str(tmp_path / "x.bmp"), "-q"])
    assert app.main(["--interactive"]) != 0  # the viewer is not ported


def test_python_dash_m_entry_point(scene_file, tmp_path):
    out = tmp_path / "m.bmp"
    res = subprocess.run([sys.executable, "-m", "chess2rt_tpu_torch", "--file", scene_file, "-o", str(out),
                          "--size", "16x12", "--device", "cpu", "-q", "--stats"],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Stages: load" in res.stdout
    assert _u8(str(out)).shape == (12, 16, 3)
    assert jax.config.jax_enable_x64 is False
