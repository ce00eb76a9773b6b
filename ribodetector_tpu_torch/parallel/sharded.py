"""Multi-host streaming coordination.

Counterpart of ``ribodetector_tpu/parallel/sharded.py``: each host parses
its own round-robin slice of the input chunk stream (chunk ownership is
deterministic, so no traffic assigns it), and the summary counters are
summed over the hosts at the end. Outputs are written per host and
concatenated in chunk order, so the merged files keep input order.

The hosts form a ``torch.distributed`` gloo group (cli.py sets it up from
--coordinator). The group carries host counters and barriers only, never a
device tensor: gloo runs on the host CPU over TCP, and, unlike NCCL, it
takes two ranks that share one card. Counters ride the collective as one
int64 tensor, so they stay exact past 2**31 reads.

The JAX package's sharded classifier has no counterpart here: several cards
on one host split each device batch in runtime/native_pipeline.py.
"""


class BarrierTimeout(RuntimeError):
    """A coordination barrier outlived its watchdog (--barrier-timeout):
    the thread that entered the collective is still blocked in it."""


def host_chunk_assignment(chunk_index: int, num_hosts: int, host_id: int) -> bool:
    """Round-robin chunk ownership: host h processes chunks with
    chunk_index % num_hosts == host_id. Deterministic, no coordination
    traffic; output files are merged in chunk order."""
    return chunk_index % num_hosts == host_id


def merge_counts(local_counts: dict) -> dict:
    """Sum per-host summary counters over every rank of the default
    process group (an all_gather of one int64 tensor, summed in int64).

    Without an initialized group (a single host) the counters come back
    unchanged. Counts must be non-negative integers."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return dict(local_counts)
    keys = sorted(local_counts)
    mine = torch.tensor([int(local_counts[k]) for k in keys], dtype=torch.int64)
    if (mine < 0).any():
        raise ValueError("summary counts must be non-negative")
    gathered = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    total = torch.stack(gathered).sum(dim=0)
    return {k: int(v) for k, v in zip(keys, total.tolist())}
