from .pipeline import AA_KERNEL, compact_indices, render_frame

__all__ = ["AA_KERNEL", "compact_indices", "render_frame"]
