from bridgelang_tpu_torch.parallel.mesh import MESH_AXES, initialize_distributed, make_mesh, strategy_mesh_spec
from bridgelang_tpu_torch.parallel.sharding import (
    batch_pspec,
    batch_sharding,
    param_pspecs,
    param_shardings,
    shard_batch,
)

__all__ = [
    "MESH_AXES",
    "initialize_distributed",
    "make_mesh",
    "strategy_mesh_spec",
    "batch_pspec",
    "batch_sharding",
    "param_pspecs",
    "param_shardings",
    "shard_batch",
]
