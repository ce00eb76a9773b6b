from ribodetector_tpu_torch.parallel.sharded import (
    BarrierTimeout,
    host_chunk_assignment,
    merge_counts,
)

__all__ = ["BarrierTimeout", "host_chunk_assignment", "merge_counts"]
