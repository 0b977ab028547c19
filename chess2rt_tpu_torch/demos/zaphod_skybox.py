"""BASELINE config #4: depth of field, a cubemap skybox and bitmap textures,
the twin of demos/zaphod_skybox.py.

The JAX demo renders zaphod.sdl, which is not in the repository, so the
twin renders the flagship stand-in with its camera's depth of field and
the sky (``scenes.flagship_standin(dof=True, env=True)``: two bitmaps, two
CSG nodes, the mirror sphere, 25 DoF samples, the camera pitched so that
about a fifth of the pixels miss every node).  The sky is the demo's
gradient cubemap (``scenes.sky_cubemap`` is its ``make_sky_cubemap``:
horizon haze to zenith blue), the miss term of the reference's environment
hook (environment.d:5-15).  Every DoF pass runs through K1's ray-input form
(csrc/round0.cu) with the merged bitmap+cubemap gather, its uniforms from
the threefry draw (csrc/threefry.cu); ``--xla`` renders the eager twin
(``render_frame_wavefront``) instead, the counterpart of the JAX demo's
pure-XLA pipeline.

    python -m chess2rt_tpu_torch.demos.zaphod_skybox --size 1920x1080 -o zaphod_sky.bmp
    python -m chess2rt_tpu_torch.demos.zaphod_skybox --adaptive-aa
    python -m chess2rt_tpu_torch.demos.zaphod_skybox --device cpu --size 64x43 --samples 2

The first frame (key ``PRNGKey(0)``, kernel builds included) is written as
a BMP; a second, steady-state frame follows under ``PRNGKey(1)``.  The
default output is ``zaphod_sky.bmp`` in the temporary directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

from ..imageio import save_image
from ..models import types as TT
from ..models.packed import pack_scene
from ..ops import prng
from ..render.pipeline import render_frame, render_frame_wavefront
from ..scenes import flagship_standin


def build(w, h, samples=None, adaptive_aa=False, device=None):
    """The stand-in with DoF and the sky at ``w`` x ``h``: (packed, static)."""
    sc = flagship_standin(TT, w, h, dof=True, env=True)
    if samples:
        sc.camera.numSamples = samples
    packed, static = pack_scene(sc, device=device)
    if adaptive_aa:
        static = dataclasses.replace(static, aa_adaptive=True)
    return packed, static


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="chess2rt_tpu_torch.demos.zaphod_skybox")
    ap.add_argument("--size", default="640x430")
    ap.add_argument("-o", "--output", default=os.path.join(tempfile.gettempdir(), "zaphod_sky.bmp"))
    ap.add_argument("--samples", type=int, default=None, help="override DoF samples")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device; cpu)")
    ap.add_argument("--xla", action="store_true",
                    help="render through the eager twin (render_frame_wavefront, plain PyTorch rounds) "
                         "instead of the fused path over K1's ray-input form")
    ap.add_argument("--adaptive-aa", action="store_true",
                    help="honor the needs-AA mask (adaptiveAA extension): the 4 AA taps, each a full "
                         "DoF loop, run lane-compacted at flagged-pixel width")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.split("x"))

    packed, static = build(w, h, args.samples, args.adaptive_aa, args.device)
    render = render_frame_wavefront if args.xla else render_frame

    def frame(key):
        t0 = time.perf_counter()
        with torch.no_grad():
            img = render(packed, static, prng.PRNGKey(key))
        if img.is_cuda:
            torch.cuda.synchronize(img.device)
        return img, time.perf_counter() - t0

    img, dt = frame(0)
    img = img.float().cpu().numpy()
    save_image(args.output, img)
    sky = img[0].mean(axis=0)
    print(f"rendered {w}x{h} in {dt:.2f}s (incl. compile) -> {args.output}")
    _, steady = frame(1)
    print(f"steady-state frame: {steady:.2f}s")
    print(f"sky row mean RGB: {sky.round(3)} (non-black => cubemap active)")
    if not img[0].max() > 0.05:
        raise AssertionError("sky should show the cubemap")
    return {"first_ms": 1e3 * dt, "steady_ms": 1e3 * steady, "sky": sky, "output": args.output, "frame": img}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
