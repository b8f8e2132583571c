from .mesh import best_mesh_shape, make_mesh
from .halo import board_sharding, make_engine_step, sharded_step_fn, sharded_step_n_fn
from .bit_halo import (
    ShardedBitPlane,
    choose_bit_layout,
    make_bit_plane,
    sharded_bit_step_n_fn,
)

__all__ = [
    "make_mesh",
    "best_mesh_shape",
    "board_sharding",
    "sharded_step_fn",
    "sharded_step_n_fn",
    "make_engine_step",
    "ShardedBitPlane",
    "choose_bit_layout",
    "make_bit_plane",
    "sharded_bit_step_n_fn",
]
