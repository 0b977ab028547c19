"""chess2rt_tpu_torch — the PyTorch/CUDA port of chess2rt_tpu.

The JAX package ``chess2rt_tpu`` is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find, and never
imports JAX.  Every Pallas TPU kernel on a ported path becomes a CUDA kernel
written by hand for Hopper (``csrc/``), built with ``nvcc`` at first use
(``cuda_build.py``) and launched from a wrapper that runs the kernel's plain
PyTorch version when its inputs lie on the CPU.

Layout:
    utils/       vec3 math, color/sRGB, structured log (host copies of the
                 JAX package's), diagnostics (ray counters, NaN sweep)
    models/      typed scene object model + packed scene tensors
    scene/       SDLang and JSON scene loader (copy)
    imageio/     BMP codec and image containers (copy); native.py, its C++
                 encoder built with g++ into build/
    oracle/      the float64 numpy oracle renderer (copy)
    ops/         camera, geometry (all-hits CSG, the scene scan, shadow
                 rays), texturing and direct shading, the round-0 kernel
                 wrapper + its plain version, its differentiable form, the
                 texel-gradient histogram, the flagship renderer, the
                 GI renderer, the threefry random numbers
    render/      render_frame dispatch: the fused paths (K1; Whitted or
                 GI) or the eager twin of the JAX package's XLA wavefront
                 and path tracer; the async multi-pass renderer and the
                 zigzag bucket list
    gui/         the interactive session (RTDemo's controls), the
                 progressive terminal / SDL viewers, the GuiDemo toy
    chess/       the reference's chess data model (copy)
    demos/       torch twins of the JAX package's inverse-rendering demos
                 and scaling recipe (python -m chess2rt_tpu_torch.demos.<name>)
    parallel/    pixel slices over a mesh of devices, in one process or
                 across processes (torch.distributed), and the dryruns
    grad/        inverse rendering (fit) and its checkpoints
    csrc/        hand-written CUDA kernels (sm_90a)
    cuda_build.py  nvcc build + ctypes binding of csrc/
    scenes.py    scenes built in code (the flagship stand-in, fuzz and CSG
                 stress scenes, a CSG-free scene, the GI stand-in) and the
                 two stand-ins as SDL
    app.py       the command line: python -m chess2rt_tpu_torch --file
                 scene.sdl -o out.bmp, or --interactive (on the card;
                 --device cpu elsewhere)
"""

__version__ = "0.1.0"

# Float32 precision policy, the counterpart of chess2rt_tpu/__init__.py's
# "highest" matmul default.  On the TPU, bf16 matmul passes corrupted the
# camera basis and the node transforms (3x3 products that every ray goes
# through); TF32 keeps ~3 decimal digits and is the same hazard on Hopper.
# The matmuls here are tiny (3x3 transforms, one-hot node gathers), so full
# float32 costs nothing.
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
