from .mesh import (
    make_mesh,
    make_sharded_render_fn,
    make_sharded_value_and_grad,
    render_frame_distributed,
)

__all__ = [
    "make_mesh",
    "make_sharded_render_fn",
    "make_sharded_value_and_grad",
    "render_frame_distributed",
]
