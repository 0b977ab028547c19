from .distributed import initialize_distributed, is_primary
from .mesh import (
    GridMesh,
    make_mesh,
    make_mesh_2d,
    make_sharded_render_fn,
    make_sharded_value_and_grad,
    render_frame_distributed,
)

__all__ = [
    "GridMesh",
    "initialize_distributed",
    "is_primary",
    "make_mesh",
    "make_mesh_2d",
    "make_sharded_render_fn",
    "make_sharded_value_and_grad",
    "render_frame_distributed",
]
