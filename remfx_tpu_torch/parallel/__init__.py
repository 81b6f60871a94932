"""Multi-device execution of the port: the mesh helpers (``mesh.py``),
the one-process-per-device launcher (``launch.py``) and sequence-parallel
inference of one long file (``sequence.py``)."""

from remfx_tpu_torch.parallel.mesh import (
    Rows,
    TimeShard,
    batch_rows,
    gather_time,
    make_mesh,
    mesh_shape,
    replicate,
    shard_batch,
    shard_params_channels,
    shard_tcn_params,
    shard_time,
    split_batch,
)

__all__ = [
    "Rows",
    "TimeShard",
    "batch_rows",
    "gather_time",
    "make_mesh",
    "mesh_shape",
    "replicate",
    "shard_batch",
    "shard_params_channels",
    "shard_tcn_params",
    "shard_time",
    "split_batch",
]
