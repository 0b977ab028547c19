"""The system under test: ``chess2rt_tpu_torch``, the PyTorch and CUDA port,
seen from the benchmark.

This is the only module of the benchmark that imports the program.  It packs
the scene that ``rtbench/scenes.py`` builds from the program's own
``models.types``, applies the configuration's settings and engine modes to
the program's ``SceneStatic``, and drives the timed entry,
``render.pipeline.render_frame``, for a frame, or the loss and
``torch.autograd.grad`` of every floating leaf for a step (as
chess2rt_tpu_torch/bench.py ``_value_and_grad`` and ``_steps_call`` do).  It
reads the program's counters: K1's launches, ``pipeline.wavefront_frames``
(frames the eager twin rendered) and the other launch counters a traced run
reports.
"""

from __future__ import annotations

import dataclasses

import torch

from . import scenes


class Port:
    """One configuration's scene packed for the program on ``device``, in
    the loop's mode (a ``frames`` or ``steps`` section of the config)."""

    def __init__(self, config: dict, mode: dict, seed: int, device):
        from chess2rt_tpu_torch.models import packed as P
        from chess2rt_tpu_torch.models import types as TT
        from chess2rt_tpu_torch.ops import round0
        from chess2rt_tpu_torch.render import pipeline

        self._P, self._round0, self._pipeline = P, round0, pipeline
        self.device = torch.device(device)
        scene = scenes.build_scene(TT, config, mode, seed)
        self.packed, static = P.pack_scene(scene, dtype=getattr(torch, config["dtype"]), device=self.device)
        self.static = dataclasses.replace(static, **mode.get("settings", {}), **mode.get("engine", {}))
        h, w = mode["height"], mode["width"]
        self.target = torch.zeros((h, w, 3), dtype=self.packed.dtype, device=self.device)
        self._xs = [x.detach().clone().requires_grad_() if x.is_floating_point() else x
                    for x in P.leaves(self.packed)]
        self._pos_at = P.LEAF_NAMES.index("camera.pos")
        self.leaf_names = [n for n, x in zip(P.LEAF_NAMES, self._xs) if x.is_floating_point()]
        self._host = None

    def _pos(self, jit):
        return self.packed.camera.pos + torch.as_tensor(jit, dtype=self.packed.camera.pos.dtype, device=self.device)

    def render(self, jit, key) -> torch.Tensor:
        """The frame of the camera moved by ``jit`` under ``key``, on the
        device."""
        cam = dataclasses.replace(self.packed.camera, pos=self._pos(jit))
        with torch.no_grad():
            return self._pipeline.render_frame(dataclasses.replace(self.packed, camera=cam), self.static, key)

    def frame(self, jit, key) -> torch.Tensor:
        """One frame as the client receives it: rendered, then copied into
        the client's frame buffer in host memory (the copy waits for the
        device).  The buffer is reused from frame to frame, as a viewer's
        is, so the window pays no fresh host pages."""
        img = self.render(jit, key)
        if self._host is None or self._host.shape != img.shape:
            self._host = torch.empty(img.shape, dtype=img.dtype)
        return self._host.copy_(img)

    def loss_and_grads(self, jit, key):
        """``((render_frame(p) - target) ** 2).mean()`` at the moved camera
        and its gradient in every floating leaf (zeros where unused), in
        ``leaf_names`` order, on the device."""
        xs = list(self._xs)
        xs[self._pos_at] = self._pos(jit).detach().requires_grad_()
        p = self._P.from_leaves(xs)
        loss = ((self._pipeline.render_frame(p, self.static, key) - self.target) ** 2).mean()
        wrt = [x for x in xs if x.requires_grad]
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        return loss.detach(), [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]

    def step(self, jit, key):
        """One gradient step as the client receives it: the loss and its
        gradients, then one host read of the loss and the gradients'
        checksum.  Returns (the loss read, the gradients on the device)."""
        loss, grads = self.loss_and_grads(jit, key)
        checksum = torch.stack([g.sum() for g in grads]).sum()
        return torch.stack([loss, checksum]).tolist()[0], grads

    def counts(self) -> dict:
        """The program's counters that tell which path an item took."""
        return {"k1": self._round0.launches, "twin": self._pipeline.wavefront_frames}

    def free(self) -> None:
        """Drop the program's scene and state (before the reference runs)."""
        self.packed = self.static = self.target = self._host = None
        self._xs = []

