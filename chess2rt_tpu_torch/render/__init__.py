from .pipeline import AA_KERNEL, compact_indices, render_frame, render_frame_wavefront, render_scene

__all__ = ["AA_KERNEL", "compact_indices", "render_frame", "render_frame_wavefront", "render_scene"]
