from ribodetector_tpu_torch.parallel.mesh import (
    Grid,
    Mesh,
    make_data_mesh,
    make_dp_tp_mesh,
    make_grid,
    replicated,
    batch_sharded,
)
from ribodetector_tpu_torch.parallel.sharded import (
    BarrierTimeout,
    make_sharded_classifier,
    host_chunk_assignment,
    merge_counts,
)

__all__ = [
    "Grid",
    "Mesh",
    "make_data_mesh",
    "make_dp_tp_mesh",
    "make_grid",
    "replicated",
    "batch_sharded",
    "BarrierTimeout",
    "make_sharded_classifier",
    "host_chunk_assignment",
    "merge_counts",
]
