"""Multi-device execution of the port: the mesh helpers (``mesh.py``) and
the one-process-per-device launcher (``launch.py``)."""

from remfx_tpu_torch.parallel.mesh import (
    Rows,
    batch_rows,
    make_mesh,
    mesh_shape,
    replicate,
    shard_batch,
    shard_params_channels,
    shard_tcn_params,
    split_batch,
)

__all__ = [
    "Rows",
    "batch_rows",
    "make_mesh",
    "mesh_shape",
    "replicate",
    "shard_batch",
    "shard_params_channels",
    "shard_tcn_params",
    "split_batch",
]
