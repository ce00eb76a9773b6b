"""Sharded classify step and multi-host streaming coordination.

Counterpart of ``ribodetector_tpu/parallel/sharded.py``. The sharded
classifier splits each batch's rows over several devices, the weights
replicated on each (the split of runtime/native_pipeline.card_slices,
which the detect runner uses for -d a,b). Each host parses
its own round-robin slice of the input chunk stream (chunk ownership is
deterministic, so no traffic assigns it), and the summary counters are
summed over the hosts at the end. Outputs are written per host and
concatenated in chunk order, so the merged files keep input order.

The hosts form a ``torch.distributed`` gloo group (cli.py sets it up from
--coordinator). The group carries host counters and barriers only, never a
device tensor: gloo runs on the host CPU over TCP, and, unlike NCCL, it
takes two ranks that share one card. Counters ride the collective as one
int64 tensor, so they stay exact past 2**31 reads.
"""

from ribodetector_tpu_torch.parallel.mesh import Mesh


def make_sharded_classifier(params, devices, *, semantics="dense",
                            compute_dtype=None, kernel="auto", mode="exact"):
    """(tokens [B, T], lengths [B]) -> logits [B, 2] on devices[0], each
    device classifying its contiguous row slice through ops.dispatch with
    its own copy of params.

    `devices` is a list of torch devices or a Mesh (its devices in order).
    B must be divisible by the device count, as the JAX package's data
    mesh requires; the runtime's power-of-two batches satisfy this for any
    power-of-two count. mode="exact" is the JAX classifier's default
    Precision.HIGHEST."""
    import torch

    from ribodetector_tpu_torch.models.bilstm import BiLSTMParams
    from ribodetector_tpu_torch.ops.dispatch import classify_logits
    from ribodetector_tpu_torch.runtime.native_pipeline import card_slices

    if isinstance(devices, Mesh):
        devices = devices.devices.ravel()
    devices = [torch.device(d) for d in devices]
    copies = [BiLSTMParams(*(p.to(d) for p in params)) for d in devices]
    compute_dtype = torch.float32 if compute_dtype is None else compute_dtype
    n = len(devices)

    def infer(tokens, lengths):
        if tokens.shape[0] % n:
            raise ValueError(f"a batch of {tokens.shape[0]} rows does not "
                             f"split over {n} devices")
        logits = []
        for dev, p, (tok, ln) in zip(devices, copies,
                                     card_slices(tokens, lengths, n, False)):
            logits.append(classify_logits(
                p, tok[0].to(dev), ln[0].to(dev), semantics=semantics,
                kernel=kernel, mode=mode, compute_dtype=compute_dtype,
            ).to(devices[0]))
        return torch.cat(logits)

    return infer


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
