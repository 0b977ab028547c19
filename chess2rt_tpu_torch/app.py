"""CLI entry point: headless render to BMP, on the card.

Counterpart of chess2rt_tpu/app.py (app.d:9-39, gui/raytracer_demo.d) with
its flags and behaviour:

* ``--file=<scene>`` (.sdl or .json); when omitted, the default scene is
  resolved like RTDemo.getPathToDefaultScene (raytracer_demo.d:19-42):
  ``$CHESS2RT_DATA_DIR`` (or the checkout's ``data/``) + the scene path
  named by ``default_scene.path``;
* the scene is pretty-printed after load unless ``-q``;
* the frame goes to ``output/img_<ISO-time>.bmp`` (raytracer_demo.d:227-238)
  when no ``--output`` is given;
* ``--debug-pixel X,Y``: the single-pixel trace dump (renderer.d:46-57),
  the device column traced by the twin's own ``render_samples`` and
  ``scene_closest`` at the chosen dtype, beside the float64 oracle.

The render runs on the card: float32 frames of the scenes K1 covers through
the fused path, float64 frames and every other scene through the eager
Whitted twin (render/pipeline.py), both on the card (it has float64).
``--device cpu`` runs it on the CPU instead; without a card and without
that flag it raises, like ``pack_scene``.  ``--backend oracle`` renders
with the float64 numpy oracle.  ``--distributed`` shards the pixels over a
mesh of the visible cards in this process (parallel/mesh.py); several
processes are ROADMAP.md queue 1 item 11, the interactive viewer item 12.
``--stats`` prints the wall time of each stage: load, device init, pack,
render (the kernel's nvcc build included on its first use) and write.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def default_scene_path() -> str:
    """``default_scene.path`` in ``$CHESS2RT_DATA_DIR``, by default the
    ``data/`` directory of the checkout."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data_dir = os.environ.get("CHESS2RT_DATA_DIR", os.path.join(root, "data"))
    pointer = os.path.join(data_dir, "default_scene.path")
    with open(pointer) as f:
        rel = f.read().strip()
    return os.path.join(data_dir, rel)


def screenshot_name() -> str:
    # img_<ISO-8601, ':' replaced>.bmp (raytracer_demo.d:44-53)
    stamp = time.strftime("%Y-%m-%dT%H.%M.%S")
    return os.path.join("output", f"img_{stamp}.bmp")


def _dtype(dtype_str: str):
    import torch

    return torch.float64 if dtype_str == "f64" else torch.float32


def _oracle_pixel_trace(scene, x: int, y: int):
    """Oracle-side single-pixel fields (float64 numpy reference)."""
    import numpy as np

    from .oracle.renderer import OracleRenderer, get_screen_rays

    r = OracleRenderer(scene)
    orig, dir = get_screen_rays(scene.camera, r.frame, np.array([float(x)]), np.array([float(y)]))
    rec, win = r.closest_hit(orig, dir)
    color = r.raytrace(orig, dir)
    return {
        "orig": orig[0],
        "dir": dir[0],
        "win": int(win[0]),
        "dist": float(rec.dist[0]),
        "color": color[0],
        "p": rec.p[0],
        "normal": rec.normal[0],
        "uv": (float(rec.u[0]), float(rec.v[0])),
    }


def _device_pixel_trace(scene, x: int, y: int, dtype_str: str, device):
    """Device-side single-pixel fields: the twin's pipeline on a one-ray
    batch at the requested dtype (raytracer_demo.d:240-266 inspects what the
    renderer did, not a re-derivation)."""
    import torch

    from .models.packed import pack_scene
    from .ops import geometry as G
    from .ops.camera import begin_frame, screen_rays
    from .render.pipeline import render_samples

    dtype = _dtype(dtype_str)
    packed, static = pack_scene(scene, dtype=dtype, device=device)
    frame = begin_frame(packed.camera, static.width / static.height)
    xs = torch.tensor([float(x)], dtype=dtype, device=packed.device)
    ys = torch.tensor([float(y)], dtype=dtype, device=packed.device)
    with torch.no_grad():
        orig, dir = screen_rays(packed.camera, frame, float(static.width), float(static.height), xs, ys)
        hit, win = G.scene_closest(packed, static, orig, dir)
        color = render_samples(packed, static, frame, xs, ys)

    def f(a):
        return a.cpu().numpy()

    return {
        "orig": f(orig)[0],
        "dir": f(dir)[0],
        "win": int(f(win)[0]),
        "dist": float(f(hit["dist"])[0]),
        "color": f(color)[0],
        "p": f(hit["p"])[0],
        "normal": f(hit["normal"])[0],
        "uv": (float(f(hit["u"])[0]), float(f(hit["v"])[0])),
    }


def debug_pixel(scene, x: int, y: int, dtype_str: str = "f32", device=None) -> str:
    """Single-pixel trace dump (raytracer_demo.d:247-265): the device
    pipeline's trace beside the float64 oracle's, so a disagreement shows."""
    dev = _device_pixel_trace(scene, x, y, dtype_str, device)
    orc = _oracle_pixel_trace(scene, x, y)

    def v3(a):
        return f"({a[0]:.6g}, {a[1]:.6g}, {a[2]:.6g})"

    def node_desc(win):
        if win < 0:
            return "miss (environment)"
        node = scene.nodes[win]
        return (
            f"'{node.name}' geometry={type(node.geometry).__name__} "
            f"shader={type(node.shader).__name__}"
        )

    rows = [
        ("Ray origin", v3(dev["orig"]), v3(orc["orig"])),
        ("Ray direction", v3(dev["dir"]), v3(orc["dir"])),
        ("Hit node", node_desc(dev["win"]), node_desc(orc["win"])),
    ]
    if dev["win"] >= 0 or orc["win"] >= 0:
        rows += [
            ("Distance", f"{dev['dist']:.6g}", f"{orc['dist']:.6g}"),
            ("Hit point", v3(dev["p"]), v3(orc["p"])),
            ("Normal", v3(dev["normal"]), v3(orc["normal"])),
            ("UV", f"({dev['uv'][0]:.6g}, {dev['uv'][1]:.6g})", f"({orc['uv'][0]:.6g}, {orc['uv'][1]:.6g})"),
        ]
    rows.append(("Color", v3(dev["color"]), v3(orc["color"])))

    wl = max(len(r[0]) for r in rows)
    wd = max(len(r[1]) for r in rows)
    lines = [
        f"Mouse click at: ({x}, {y})",
        f"  {'':{wl}}   {'device (' + dtype_str + ')':{wd}}   oracle (f64)",
    ]
    for name, d, o in rows:
        marker = "" if d == o else "   <- differs"
        lines.append(f"  {name:{wl}}   {d:{wd}}   {o}{marker}")
    return "\n".join(lines)


def _synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chess2rt_tpu_torch", description=__doc__.split("\n")[0])
    ap.add_argument("--file", default=None, help="scene file (.sdl or .json)")
    ap.add_argument("--output", "-o", default=None, help="output BMP path (default: output/img_<time>.bmp)")
    ap.add_argument("--size", default=None, help="override frame size, WxH")
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--backend", choices=["torch", "oracle"], default="torch",
                    help="torch = the port's pipeline; oracle = the float64 numpy reference")
    ap.add_argument("--device", default=None,
                    help="torch device to render on (default: the current CUDA device; cpu to run without a card)")
    ap.add_argument("--distributed", action="store_true",
                    help="shard pixels over a mesh of the visible cards, in this process")
    ap.add_argument("--debug-pixel", default=None, metavar="X,Y",
                    help="dump a single-pixel trace (click-to-inspect parity) and exit")
    ap.add_argument("--interactive", action="store_true",
                    help="the progressive viewer (not ported: ROADMAP.md queue 1 item 12)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", "-q", action="store_true", help="skip the scene dump")
    ap.add_argument("--stats", action="store_true", help="print per-frame and per-stage timing")
    ap.add_argument("--log-json", default=None, metavar="PATH",
                    help="append structured JSON-lines event records (scene "
                         "load, frame timing) to PATH ('-' = stderr)")
    args = ap.parse_args(argv)

    if args.interactive:
        print("chess2rt_tpu_torch: --interactive (the progressive viewer) is not ported yet "
              "(ROADMAP.md queue 1 item 12: host apps)", file=sys.stderr)
        return 2

    import torch

    from .scene.loader import parse_scene_from_file
    from .utils import structlog

    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("chess2rt_tpu_torch: no CUDA device; pass --device cpu to run on the CPU")
    device = torch.device(args.device) if args.device else torch.device("cuda", torch.cuda.current_device())

    if args.log_json:
        stream = sys.stderr if args.log_json == "-" else open(args.log_json, "a")
        structlog.configure(stream=stream)
    log = structlog.get_logger()

    stages = {}
    t = time.perf_counter()
    path = args.file or default_scene_path()
    scene = parse_scene_from_file(path)
    stages["load"] = time.perf_counter() - t
    log.emit("scene_loaded", path=path, nodes=len(scene.nodes), lights=len(scene.lights))

    if args.size:
        w, h = (int(v) for v in args.size.lower().split("x"))
        scene.settings.frameWidth, scene.settings.frameHeight = w, h
        scene.camera.set_frame_size(w, h)

    if not args.quiet:
        print(f"Loading scene: {path}")
        print(scene.pretty())

    if args.debug_pixel:
        x, y = (int(v) for v in args.debug_pixel.split(","))
        print(debug_pixel(scene, x, y, args.dtype, device))
        return 0

    frame_rec = {"scene": path, "backend": args.backend, "dtype": args.dtype, "device": str(device),
                 "width": scene.settings.frameWidth, "height": scene.settings.frameHeight}
    t0 = time.perf_counter()
    if args.backend == "oracle":
        from .oracle import render_scene

        img = render_scene(scene, seed=args.seed)
        stages["render"] = time.perf_counter() - t0
    else:
        from .models.packed import pack_scene

        # the device's context, so that pack and render time their own work
        t = time.perf_counter()
        torch.zeros((), device=device)
        _synchronize(device)
        stages["init"] = time.perf_counter() - t

        t = time.perf_counter()
        packed, static = pack_scene(scene, dtype=_dtype(args.dtype), device=device)
        _synchronize(device)
        stages["pack"] = time.perf_counter() - t

        t = time.perf_counter()
        with torch.no_grad():
            if args.distributed:
                from .parallel import make_mesh, render_frame_distributed

                mesh = make_mesh() if device.type == "cuda" else make_mesh((device,))
                img = render_frame_distributed(packed, static, mesh)
            else:
                from .render.pipeline import render_frame

                img = render_frame(packed, static)
            img = img.cpu().numpy()
        stages["render"] = time.perf_counter() - t
    dt = time.perf_counter() - t0
    log.emit("frame", wall_ms=round(dt * 1e3, 3), **frame_rec)

    t = time.perf_counter()
    out_path = args.output or screenshot_name()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    from .imageio.bmp import save_bmp_file

    save_bmp_file(out_path, img)
    stages["write"] = time.perf_counter() - t
    print(f"Saved {scene.settings.frameWidth}x{scene.settings.frameHeight} render to {out_path}")
    if args.stats:
        npx = scene.settings.frameWidth * scene.settings.frameHeight
        print(f"Frame time: {dt:.3f} s ({npx/dt/1e6:.2f} Mpx/s, backend={args.backend}, device={device})")
        print("Stages: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()))
    log.emit("stages", **{f"{k}_ms": round(v * 1e3, 3) for k, v in stages.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
