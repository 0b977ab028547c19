"""chess2rt_tpu_torch — the PyTorch/CUDA port of chess2rt_tpu.

The JAX package ``chess2rt_tpu`` is the reference; this package mirrors its
layout and names so each module's counterpart is easy to find, and never
imports JAX.  Every Pallas TPU kernel on a ported path becomes a CUDA kernel
written by hand for Hopper (``csrc/``), built with ``nvcc`` at first use
(``cuda_build.py``) and launched from a wrapper that runs the kernel's plain
PyTorch version when its inputs lie on the CPU.

Layout:
    utils/       vec3 math, color/sRGB (host copies of the JAX package's)
    models/      typed scene object model + packed scene tensors
    ops/         camera, the round-0 kernel wrapper + its plain version,
                 its differentiable form, deferred bitmap texturing and the
                 texel-gradient histogram, the flagship renderer
    render/      render_frame dispatch, AA taps, compaction helper
    grad/        inverse rendering (fit) and its checkpoints
    csrc/        hand-written CUDA kernels (sm_90a)
    cuda_build.py  nvcc build + ctypes binding of csrc/
    scenes.py    the code-built flagship stand-in scene
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
